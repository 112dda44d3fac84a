"""ssl_tpu_torch — the PyTorch/CUDA port of ``ssl_tpu`` for NVIDIA Hopper.

Module paths mirror ``ssl_tpu/`` so each piece has an obvious counterpart;
inside the modules the idiom is PyTorch: ``nn.Module`` in NCHW, plain tensor
functions, explicit devices and ``torch.Generator`` seeds, and
``torch.autograd.Function`` around the hand-written kernels.

Layout
------
- ``ssl_tpu_torch.ops``     SSG semantics (plain PyTorch) and the K1 CUDA kernel;
                            attention and the K2 forward and backward kernels
- ``ssl_tpu_torch.losses``  pixel / KL / GAN / perceptual / SSL losses
- ``ssl_tpu_torch.archs``   RRDBNet, VGGStyleDiscriminator, VGG19 feature taps
- ``ssl_tpu_torch.models``  the ESRGAN-SSL training recipe: step, inference,
                            validation, checkpoints
- ``ssl_tpu_torch.data``    paired (mask) datasets, the sampler and loader
- ``ssl_tpu_torch.metrics`` PSNR / SSIM
- ``ssl_tpu_torch.train``, ``ssl_tpu_torch.test``  the ``-opt`` CLIs
- ``ssl_tpu_torch.utils``   registries, options, logger, image IO (PNG
                            without ``cv2``: ``utils/png.py``)
- ``ssl_tpu_torch.diffusion`` StableSR-SSL: train step, samplers, inference CLI
- ``ssl_tpu_torch.parallel`` torch.distributed: DDP, FSDP, spatial and tensor
                            parallelism under ``torchrun``
- ``ssl_tpu_torch.csrc``    CUDA C++ sources, compiled with nvcc at first use

The package imports neither JAX nor ``ssl_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
