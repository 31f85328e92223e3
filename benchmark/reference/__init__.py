"""The benchmark's plain reference: the renderer (``render.py``) and one
module per scene kind, found by the ``kind`` a configuration names. Plain
PyTorch; nothing here imports the program under test."""
