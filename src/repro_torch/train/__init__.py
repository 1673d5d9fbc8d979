"""The training path (counterpart of ``repro.train``): the token stream,
AdamW, the train step with microbatching and remat, error-feedback
gradient quantisation and checkpoints."""
