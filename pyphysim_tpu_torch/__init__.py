"""pyphysim_tpu_torch — the PyTorch / CUDA port of ``pyphysim_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. Today it covers the flagship Monte Carlo BER
chain (16-QAM, OFDM, COST259 TDL channel with Jakes Doppler, AWGN, one-tap
equalizer, hard demodulation, bit-error count) along three routes: the
whole repetition in one hand-written CUDA kernel through the
``SimulationRunner`` bulk path (``ops/mc_kernel.py``,
``ops/csrc/mc_ofdm_tdl.cu``), and the time-domain and fused chains
(``chain.py``) through its per-key path, whose block-static channel
convolves with the ``block_fir`` CUDA kernel (``ops/fir.py``,
``ops/csrc/block_fir.cu``).

Importing this package imports nothing heavy: ``torch`` is pulled in by the
submodules that need it, and the CUDA library is built and loaded on the
first kernel launch (``ops/_build.py``). Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
