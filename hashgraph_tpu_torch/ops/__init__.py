"""Device ops of the PyTorch port: the decision rule, the ingest bodies and
the hand-written CUDA ingest scan (:mod:`.cuda_ingest`)."""
