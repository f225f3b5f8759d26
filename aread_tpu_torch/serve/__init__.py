"""Serving: ``Predictor`` / ``load_predictor``, the HTTP front end and the
``python -m aread_tpu_torch.serve`` CLI."""
