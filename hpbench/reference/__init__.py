"""The plain PyTorch reference of the benchmark's configurations: NlosPose's
forward (``model.py``), its light-cone transform (``lct.py``) and its
train step (``train.py``).  Imports nothing of the program under test."""
