"""The video-prediction inference CLI (``predict``) and its npz sample
parser (``utils``), the port of ``inference/``."""
