"""The VP2 visual-planning predictor (``interface``), the port of
``ivideogpt_tpu/vp``."""
