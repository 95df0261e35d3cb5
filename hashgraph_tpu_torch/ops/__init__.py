"""Device ops of the PyTorch port: the decision rule, the ingest bodies,
the hand-written CUDA ingest scan (:mod:`.cuda_ingest`) and the batched
vote-chain check (:mod:`.chain`)."""
