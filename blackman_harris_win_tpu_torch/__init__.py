"""PyTorch + CUDA port of ``blackman_harris_win_tpu``.

Bit-exact fixed-point cosine-sum window generation, the Welch power
spectrum analyzer and the signal chains the windows feed (decimating FIR,
DDC, polyphase channelizer + FM demod, STFT/WOLA), with the JAX package's
hot kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``).  The
layout mirrors the JAX package (``core/``, ``windows/``, ``kernels/``,
``pipeline/``), so each module's counterpart has the same path.  This
package never imports ``jax``.

Entry points run on the card unless the caller asks for the CPU: a
``device`` argument defaults to the current CUDA device.  Every kernel
wrapper dispatches on the tensor's device: on the CPU it runs the kernel's
plain PyTorch version, on CUDA it launches the kernel or raises.
"""
