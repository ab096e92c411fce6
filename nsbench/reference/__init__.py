"""The plain reference of the benchmark's correctness check: P2-P1 finite
elements in NumPy and PyTorch (`fem.py`), one module a problem
(`dfg3d.py`), and the comparison and its control (`check.py`).  It imports
nothing of the program and takes nothing the program made."""
