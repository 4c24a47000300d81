"""Serving (counterpart of supir_tpu/serve/): the controller's worker
registry and dispatch, model workers for restoration and caption requests,
and the captioner's web chat, on the Python stdlib's HTTP server."""
