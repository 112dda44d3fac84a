"""ssl_tpu_torch — the PyTorch/CUDA port of ``ssl_tpu`` for NVIDIA Hopper.

Module paths mirror ``ssl_tpu/`` so each piece has an obvious counterpart;
inside the modules the idiom is PyTorch: ``nn.Module`` in NCHW, plain tensor
functions, explicit devices and ``torch.Generator`` seeds, and
``torch.autograd.Function`` around the hand-written kernel.

Layout
------
- ``ssl_tpu_torch.ops``     SSG semantics (plain PyTorch) and the K1 CUDA kernel
- ``ssl_tpu_torch.losses``  pixel / KL / GAN / perceptual / SSL losses
- ``ssl_tpu_torch.archs``   RRDBNet, VGGStyleDiscriminator, VGG19 feature taps
- ``ssl_tpu_torch.models``  the ESRGAN-SSL training recipe
- ``ssl_tpu_torch.csrc``    CUDA C++ sources, compiled with nvcc at first use

The package imports neither JAX nor ``ssl_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
