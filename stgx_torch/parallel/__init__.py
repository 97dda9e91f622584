"""Training on one device — the port of the single-device parts of
``stgx/parallel``: length buckets (:mod:`stgx_torch.parallel.segments`) and
the trainer (:mod:`stgx_torch.parallel.loop`)."""
