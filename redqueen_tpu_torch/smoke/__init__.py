"""The phases of ``chip_smoke.py``, the smoke run of the port on one
NVIDIA card, one module per group of phases.  The script at the root of
the repository drives them; importing this package runs nothing."""
