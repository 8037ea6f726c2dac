"""SwitchAgg core, ported to PyTorch (counterpart of ``repro.core``).

Modules of this slice:
  reduction_model — paper Eq. 1-3, simulators (numpy copy)
  aggops          — the AggOp registry: one source of op semantics
                    (combine/identity/segment reduce; DESIGN.md §6)
  kvagg           — FPE/BPE bounded-memory KV combine
  dataplane       — plan-driven multi-level cascade executor + telemetry
  compressor      — gradient -> KV payload (top-k + error feedback)

Submodules are imported explicitly (``from repro_torch.core import
kvagg``); nothing is imported eagerly here.
"""
