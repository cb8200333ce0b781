"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
worked out from the configuration, the traffic and the input bytes alone.
It imports nothing of the program (``dspsr_tpu_torch``) and nothing of
JAX."""
