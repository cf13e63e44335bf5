"""Qualitative renders (``render.py``) and raw-dataset renders (``raw.py``); matplotlib and
Pillow are imported inside the functions that draw."""
