"""K2's roofline (``csrc/banded_nw_long.cu``, the banded NW forward for
bands of 33 to 1,024, long reads' W = 256): K2 keeps K1's input and output
contract, so its least time is K1's count, ``roofline/k1.py`` (frozen from
``chip_smoke.py::nw_bound``), at K2's shapes."""

from hlabench.spec import roofline

bound_s = roofline("k1").bound_s
