"""PyTorch + CUDA port of ``blackman_harris_win_tpu``.

Bit-exact fixed-point cosine-sum window generation and the Welch power
spectrum analyzer, with the JAX package's hot kernels rewritten by hand in
CUDA C++ for Hopper (``csrc/``).  The layout mirrors the JAX package
(``core/``, ``windows/``, ``kernels/``, ``pipeline/``), so each module's
counterpart has the same path.  This package never imports ``jax``.

Every kernel wrapper dispatches on the tensor's device: on the CPU it runs
the kernel's plain PyTorch version, on CUDA it launches the kernel or
raises.
"""
