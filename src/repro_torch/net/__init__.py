"""Network layer of the port (counterpart of ``repro.net``).

Only ``wire`` (MTU framing of KV records; THE byte-size constants) is
ported so far: ``core.reduction_model`` imports it, and its
``RECORDS_PER_PACKET`` sizes the streaming ingest.
"""
