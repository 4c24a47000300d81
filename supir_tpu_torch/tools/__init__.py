"""The decode-GEMV probes on the card: the counterparts of the Pallas probes
in the JAX package's `tools/` (stream_ceiling T1, gemv_sweep T2,
bitcast_probe T3, int4_native_probe T4), each run as
`python -m supir_tpu_torch.tools.<name>`, with the chained timer they share
(`timing`). Nothing here runs at import time."""
