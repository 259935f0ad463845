"""Plain references the benchmark judges the program by.

Plain PyTorch on int64 and float64 tensors, worked out from the published
coefficients and the HLS fixed-point contract; they import nothing of the
program and nothing of JAX, and take nothing the program made.
"""
