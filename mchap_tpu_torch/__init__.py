"""mchap_tpu_torch — the PyTorch/CUDA port of ``mchap_tpu``.

Micro-haplotype assembly in autopolyploids (MCHap), with the de novo
sampler step in a hand-written CUDA kernel for NVIDIA Hopper
(``csrc/denovo_sampler.cu``).  The package never imports JAX or
``mchap_tpu``; the host IO and encoding modules are copies of
``mchap_tpu``'s (tests/test_torch_port_hygiene.py keeps them in sync).

Entry point: ``python -m mchap_tpu_torch assemble ...``.
"""

__version__ = "0.1.0"
