"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; the first failure exits non-zero.  The
zoo phase's CPU references start first, in processes of their own beside
the phases before it; the metrics phase (12), which needs none of the
port's kernels, runs on the card while they build; the recipes phase (15)
runs in a process of its own beside diffusion_cli (9), and the parallel
phase's dist_train.sh (18b) beside prep_infer (17).  The StableSR-SSL
training runs accumulate 4 mini-steps an update (ssl_base.yml: 12):

1. build   compile the port's CUDA kernels (K1 ssg_loss_fwd, K2
           flash_attn_fwd and flash_attn_bwd) with nvcc, one process per
           source, all at once
2. kernel  hold K1 (ssl_tpu_torch/csrc/ssg_loss_fwd.cu) against its plain
           PyTorch version on the card: a small case (search 9, window 5),
           the shipped search 25 / window 9 / sigma 0.004 on smooth images
           at 32^2, at the ESRGAN step's shape (b16, 3x128^2), at the
           diffusion mini-step's (b2, 3x512^2) and at the RealESRGAN-SSL
           step's (b12, 3x400^2, with real edge masks; b12, 3x256^2 in its
           host mode), at the KAIR recipes' (b48, 3x256^2; b64,
           3x192^2; b16, 3x256^2, real edge masks on the stride-3 lattice),
           and the ESRGAN
           step's own inputs (bench.py's uniform images, on which every off-centre q is
           0), at bench.py's step's (b24, 3x128^2) in float32 and in K1's
           bf16 stream + store mode (the stored route: the walk, which
           writes the q stack, then the stream over it; the stack held
           alone against its plain version, its one-ulp bf16 flips
           counted, and the stream alone on the walk's stack, each bit for
           bit on a repeat; the call's peak memory), and at BSRGAN-SSL's
           shape with the bf16 knobs (the batched route: K1's stream mode);
           forward outputs and d_sr through the autograd function, with
           the L1 subgradient's ties (and, with the bf16 store, q at a bf16
           rounding boundary) accounted for, where K1's d_sr misses the
           strict bound against the plain version the float64 criterion
           (``d_sr_float64``), and a second launch bit
           for bit; times the kernel (CUDA events and the profiler), the
           plain forward and the backward.  Then hold K2's forward
           (ssl_tpu_torch/csrc/flash_attn_fwd.cu: flash_attn_fwd, at d = 512
           flash_attn_fwd_d512, and flash_attn_fwd_combine where the key
           loop is split) against its plain version at each shape the
           serving path gives it and at one case with logits up to 50, and a
           second launch bit for bit; times each kernel (profiler), the
           wrapper, the plain version and torch's
           scaled_dot_product_attention (the yardstick, which the port never
           calls).  Then K2's backward
           (ssl_tpu_torch/csrc/flash_attn_bwd.cu: dkv and dq, the ordered sum
           of split parts, and at d = 512 p_ds, dkv_mm and dq_mm) and the
           forward's lse at each shape of the training path: against
           flash_attn_bwd_reference and autograd through the plain
           attention, and a second launch bit for bit against the first;
           times the kernels (each alone from the profiler), the plain
           backward and SDPA's backward.  TF32 is off throughout for the
           plain versions; the kernels' own products are 3xTF32.  Then
           K2's bf16 kernels (the ``_bf16`` kernels of the same sources,
           for compute_dtype bfloat16) at the same shapes on bf16 inputs,
           the packed-qkv strides included: the forward's o within 5e-3
           relative L2 of the float32 plain version on the inputs upcast
           and at most 1.5x the plain bf16 route's error, the backward's
           dq, dk and dv (fed the float32 reference's o and lse) within
           1e-2 and at most 1.5x ``flash_attn_bwd_reference`` on the bf16
           inputs, each bit for bit on repeat; times with SDPA in bf16 as
           the yardstick and bounds with bf16 products at 989 TFLOP/s and
           2-byte operands.  Then the two bf16 kernels of the VAE's head
           (d = 512: the forward, and the backward's P and dS) at vae_mid
           with b = 1 and b = 2, each held there by the bf16 holds above
           (the backward fed the forward kernel's own o and lse) and timed
           beside its bound and SDPA's device time.  At each serving shape
           where the bf16 forward splits its key loop, its combine
           (flash_attn_fwd_combine_bf16) alone on seeded parts against its
           plain version, bit for bit on a repeat, timed beside its bound
           and its per-launch floor.  K2's holds and times run before K1's.
3. diffusion  the StableSR-SSL model of options/diffusion/ssl_base.yml at
           full width with model.use_flash_attention on, random weights from
           seeds; every layer the init leaves at 0 is drawn from a seeded
           normal, so that the attention reaches the UNet's output
4. e2e     one 256^2 request (5 spaced-DDPM steps, TF32 off) through the K2
           route and through the plain route on the same generator seeds;
           the decoded images must agree to E2E_REL_L2 (relative L2)
5. serve   2 requests, each a 128^2 smooth LQ image upsampled to 512^2:
           VAE encode -> 50 spaced-DDPM steps -> decode -> AdaIN color fix,
           through the inference CLI's own ``restore``; times per request,
           per denoising step, VAE encode and decode, peak memory, and the
           K2 launch count, which must be 14 per step and 2 per request,
           with every forward kernel launched
6. train_e2e  one training mini-step at 256^2, batch 2, TF32 off, through
           the K2 route and the plain route from the same weights and draws:
           the logs within TRAIN_LOG_RTOL and every parameter's gradient
           within TRAIN_GRAD_REL_L2; K2 launches as derived
7. diffusion_bf16  the same model under model.compute_dtype bfloat16
           (build_from_config with the key; the same seeded weights):
           the UNet eps and the VAE decode against float32 within 3e-2 of
           its scale, a 256^2 request on the bf16 K2 and bf16 plain routes
           against the float32 K2 route (the K2 route's relative L2 at most
           1.25x the plain route's), 512^2 requests and 512^2, batch 2
           mini-steps in turns bf16, float32, float32, bf16 (ms per request,
           per denoising step and per mini-step, peak memory, device
           launches per step; K2 14 per step and 17 forward, 15 backward a
           mini-step, all bf16 kernels; the UNet gradient's cosine to
           float32 above 0.98), then 4 mini-steps through the training CLI
           with model.compute_dtype=bfloat16 as an override (one update)
8. diffusion_train  the shipped training options (lr 5e-5, EMA 0.9999;
           4 mini-steps per update) at 512^2, batch 2, on smooth synthetic
           GT/LQ with a mask of density 0.25: one full accumulation cycle of
           4 mini-steps through train_step; logs finite, weights unchanged
           after mini-steps 1-3 and moved after 4, the EMA moved, K1 once
           and K2 17 forward and 15 backward per mini-step, every K2
           kernel launched; times, peak memory and K2's forward and
           backward device time per mini-step
8b. cfw    StableSR's stage 2 at full width, on the diffusion phase's
           seeded model: (a) that model written as a full StableSR-layout
           .ckpt and imported through model.vae_ckpt and model.ckpt_path,
           every parameter and one denoiser output (cuDNN deterministic,
           TF32 off) bit for bit the original's; (b) the dump entry point
           (ssl_tpu_torch.scripts.gt_input_output) on 4 GT PNGs of 512^2
           with 4 DDPM steps; (c) the CFW CLI (ssl_tpu_torch.diffusion.
           cfw_train) on the reference's configs/autoencoder/
           autoencoder_kl_64x64x4_resi.yaml (its widths, 512^2, batch 2;
           pretrain_vae a reference-layout .ckpt of the seeded VAE) with
           vae.use_flash_attention=true and network_d.type=
           NLayerDiscriminator as overrides: 2 steps (K2 3 forward and 1
           backward a step, losses finite), cfw_state_2.pkl reloaded bit for
           bit, the decoder moved and the frozen encoder the imported VAE's,
           --resume to 3; (d) in process on the dump's first batch: a float32
           step with the flash switch on against the same step with it off
           (cuDNN deterministic, TF32 off; losses within TRAIN_LOG_RTOL, the
           trained weights within lr/5), K2 held on that step's own q, k, v
           (the encoder's forward, the decoder's forward, lse and backward),
           one bf16 step with K2's bf16 kernels held likewise (each output
           at most 1.5x the plain bf16 version's error against float32, the
           d = 512 bf16 phase's absolute bounds reported beside:
           hold_k2_cfw), then ms per
           step in turns bf16, float32, float32, bf16 with peak memory;
           (e) test_cli --vqgan_ckpt cfw_3.pkl on 2 LQ PNGs of 128^2 (10 DDPM
           steps), each within one level of the same request in process,
           different from the plain VAE's decode, finite; ms per image
           with and without the CFW decoder
9. diffusion_cli  StableSR-SSL training through its CLI
           (ssl_tpu_torch.diffusion.main --train) at the same width with
           model.use_flash_attention=true as a dotlist override, on files:
           24 GT PNGs of 512^2 made on the card, .mat masks from the
           generate_mask entry point, a .json base file with ssl_base.yml's
           values (crop 512, batch 2, 4 loader processes, the shipped
           degradation block on the host degrader, 4 mini-steps an update);
           4 mini-steps (one update: losses finite, K1 1, K2 17 forward and
           15 backward per mini-step, the weights moved at mini-step 4 only),
           ckpt_4.pkl in the JAX layout, train_state_4.pkl reloaded bit
           for bit, --resume auto to 8 (moved at 8 only), the test CLI on
           ckpt_4.pkl and ckpt_8.pkl (one 512^2 request of 10 steps each:
           two different images); the host C++ filter2d and JPEG held against their numpy
           versions on 2 x 512^2; ms per mini-step, data wait and the host
           degrader's share from the CLI's timers
9b. zoo    the gather API, the strategy zoo and PerceptualSimLoss, TF32
           off: (a) the gather route (impl: scan) against K1's dense route
           at the ESRGAN-SSL step's shape (b16, 3x128^2 pictures with real
           edge masks, the capacity at the largest edge count): l1 within
           1e-4, kl within 1e-3 relative, d_sr within D_SR_REL_L2; ms
           forward + backward, device launches and peak memory of each;
           (b) selfsim1_opt.softmax on the gather route on two of those
           pictures, card against CPU in float64 within 1e-10; (c) every key of the zoo that
           ssl_loss takes at b2 3x128^2 (mask stride 3, capacity 2048, the
           zoo's default options), card against CPU in float64 within
           1e-10 on the losses and d_sr, float32 reported with its ms;
           (e) PerceptualSimLoss with every term on, card against CPU in
           float64 at 128^2, timed at 512^2 b2; (d) 8 mini-steps (two
           updates) of the StableSR-SSL training CLI with
           sslopt.simself_strategy=areaarea_mask_nonlocal_cuda_v1 and
           model.use_flash_attention=true on diffusion_cli's kind of data:
           losses finite, l_selfsim > 0, the weights moved at mini-steps
           4 and 8 only (the accumulation restarts within one process),
           no K1 and K2 17 forward and 15
           backward per mini-step (diffusion_cli's), ms per mini-step, peak
           memory, edge pixels per image against the capacity
10. train   the ESRGAN-SSL train step at the shipped widths (RRDBNet 64/23/32,
           VGGStyleDiscriminator 64, VGG19 conv5_4, SSL 25/9/0.004), batch 16,
           gt 128: one warm-up step and 3 timed steps through build_model ->
           init_state -> train_step, with the K1 launch count read around
           them
11. bench  bench.py's ESRGAN-SSL step (bench.py:54-116: batch 24, gt 128,
           RRDBNet 64/23/32 and UNetDiscriminatorSN 64 in bf16, VGG19
           conv5_4 in float32, SSL 25/9/0.004 with the bf16 q store and
           stream) through build_model -> init_state -> train_step, and the
           same with its bf16 knobs in float32: the bf16 G's image and D's
           logits held against float32 within 3e-2 of scale, then the two
           in turns (bf16, float32, float32, bf16), each run a warm-up and 3
           timed steps (ms/step, imgs/s, peak memory, K1 once a step in the
           run's mode, losses finite; G, D and EMA moved)
12. metrics the metric suite on the card (NIQE on the host): seeded
           checkpoints at full width in each official layout, written to a temp
           directory and pointed to by LPIPS_ALEX_PTH + ALEXNET_PTH, DISTS_PTH +
           VGG16_PTH, FID_INCEPTION_PTH, CLIP_RN50_PTH (RN50's widths) and
           CLIP_BPE_PATH; a LPIPS or DISTS checkpoint without its backbone
           refused; LPIPS, DISTS, FID's pool3 features and CLIP-IQA (score and
           both towers' features) held float32 on the card with TF32 off against
           float64 on the CPU, and read once more with TF32 on as the control,
           which must fall outside each bound; each metric's ms per image at 512^2 and 2040 x
           1356, NIQE's on the host at 512^2, FID over 16 PNGs at batch 8 through
           the FID CLI's folder_features, the host's Frechet distance, peak
           memory.  The later phases' test CLI runs score the shipped test YAMLs'
           metrics (TEST_METRICS: PSNR, SSIM, LPIPS, DISTS) and report the
           seconds LPIPS and DISTS add and each run's time net of them
13. cli    the ESRGAN-SSL train and test CLIs (ssl_tpu_torch.train /
           ssl_tpu_torch.test) at the same widths on files: 24 GT PNGs of
           192^2 written through utils/png.py, their LQ and .mat edge masks
           made on the card, read by 4 loader processes; a .json option file
           with the shipped YAML's values; 4 iterations (K1 once each) with
           validation (PSNR/SSIM) and checkpoints, with cv2 hidden so that
           PNG decodes through utils/png.py; the training state reloaded into
           a fresh model bit for bit; --auto_resume to 6 (K1 twice more,
           decoding with cv2 where it imports); the test CLI on net_g_6.pth
           whole and tiled (TEST_METRICS); times per iteration and the loader's data wait
           from the logger's timers, and the loader alone with each decoder
14. realesrgan  the RealESRGAN-SSL train and test CLIs at the shipped widths
           (RRDBNet 64/23/32, UNetDiscriminatorSN 64, VGG19 at five layers,
           SSL 25/9/0.004) on files: 24 GT PNGs of 512^2 made on the card,
           their .mat masks from the generate_mask entry point, a .json
           option file with the shipped YAML's values (batch 12, crop_pre
           400, 6 loader processes; the pool cut to 24 slots); 4 iterations
           (each degrades the batch on the card, makes the USM target and
           passes the pool; K1 once each; the pool pointer 24 after 2), the
           training state reloaded bit for bit with the pool and the
           generators, --auto_resume to 6, the test CLI on a BlindLR-style
           set (PSNR/SSIM); the degradation + USM + pool timed alone, and
           the degradation held card against CPU with TF32 off; then 3
           iterations with degradation_device: false (the host degrader:
           crop to gt_size 256, the host pool full at the third, its
           streams and pool reloaded bit for bit).  K1 is also held at its
           shapes (b12, 3x400^2 and 3x256^2) in the kernel phase, on
           pictures with real edge masks
15. recipes the six bicubic GAN-SSL recipes (LDL, BebyGAN, SPSR,
           RankSRGAN-PI, SwinIR-GAN, ELAN-GAN) through the train and test
           CLIs at their shipped widths on the cli phase's files: the
           options/train/<recipe> YAML's values in a .json file, batch 16, 4
           loader processes, 2 iterations with a checkpoint (losses finite
           with the recipe's own keys logged, K1 once per iteration and the
           plain SSL forward never on the card), the training state reloaded
           bit for bit (SPSR's gradient D and RankSRGAN's Ranker included),
           --auto_resume to 3, the test CLI whole (and for SwinIR-GAN also
           tiled); K1 held against
           its plain version on SwinIR's and ELAN's SR of 16 training pairs;
           ms per iteration, data wait, the first iteration's extra time,
           peak memory and the test CLI's ms per image
16. kair   the KAIR/BSRGAN GAN-SSL family (BSRGAN-SSL, ELAN-GAN-SSL,
           SwinIR-GAN-SSL on the BSRGAN degradation) through the train and
           test CLIs: each options/train/<recipe>/*.json (a KAIR-schema file,
           through utils/kair_options.py) at its widths (SwinIR's netG
           widths through --force_yml, which the adapter drops) and batch
           (48 / 64 / 16) in 6 loader processes on 64 GT PNGs of 288^2 made on
           the card, .mat masks from the generate_mask entry point, with cv2
           hidden (the host BSRGAN degradation's resize and JPEG, and the PNG
           decode, are the port's own); 2 iterations with a save (losses
           finite, K1 once per iteration, the stride-3 mask applied, the plain
           SSL forward never on the card), the training state reloaded bit for
           bit, --auto_resume to 3, the test CLI with the shipped test YAML's
           model (BSGRANTestModel / BSGRANTestSwinIRModel) and G on a
           BlindLR-style set whole and tiled; the loader alone; K1 held on
           BSRGAN-SSL's SR of 16 degraded pairs with the stride-3 mask, for
           three seeds of the pairs, each also by the float64 criterion
           (``d_sr_float64``), and on the wide-range SR of the same G drawn
           with flax's init variance (std ~9: the inverse maps within 1e-4 of
           a float64 run, ``hold_k1_wide``)
17. prep_infer  from HR images to SR images with the port alone, through the
           entry points a user calls: 24 HR PNGs of 400 x 520 made on the card;
           generate_bicubic_lr --mod 12 --gt_output (GT 396 x 516, LR 99 x 129)
           and generate_mask; the ESRGAN-SSL train CLI at the shipped YAML's
           values (batch 16, gt 128, 4 loader processes) for 2 iterations (K1
           once each, losses finite, net_g_2.pth written); inference_ssl_sr
           whole and tiled, inference_rrdbnet on that net_g and inference_swinir
           at the shipped SwinIR-GAN-SSL test YAML's width on seeded weights,
           each on 8 LR images (ms per image, peak memory), each first image on
           the card with TF32 off against the same CLI with --device cpu (within
           one level on at most 0.1% of the values) and inference_ssl_sr's SR
           against the test CLI's within one level; back_projection on 4 SR,
           generate_realesrgan_bsrgan_lr on 4 HR with the shipped option file's
           values; one 2040 x 1356 HR through generate_bicubic_lr and the four
           entry points (the DIV2K-valid times); the registry hold: the seven
           archs the port added for it (UNetDiscriminatorSNv1, MOD,
           Discriminator_VGG_192, DiscriminatorSN_VGG_192, NLayerDiscriminator,
           RRDBPSNet, RRDBMeanNet) at their default widths, forward and backward
           on the card against the CPU in float64 with TF32 off: in float64
           within 1e-10 relative L2; in float32 the output within 1e-4 and the
           gradients reported beside the CPU float32's (a leaky ReLU's kink
           within rounding moves a float32 gradient by ~1e-4)
18. parallel torch.distributed at one rank under NCCL (phase_parallel):
           (a) the ESRGAN-SSL train CLI at the cli phase's widths and data,
           3 iterations with --launcher none and with --launcher pytorch
           (DDP, the synced batch norm, the global relativistic means and
           SSL count), cuDNN deterministic and TF32 off: losses within rtol
           1e-4 and weights within lr / 5 (+2.2 lr where a gradient was
           rounding noise) of the none run's, K1 once per iteration, net_g's
           file unprefixed and loading into the plain net, --auto_resume to
           4, ms per iteration of each in turns (none, pytorch, pytorch,
           none);
           (b) ssl_tpu_torch/scripts/dist_train.sh under torchrun
           --standalone, one rank, 2 iterations at small widths (the launch
           path), rank 0's files written; it starts before prep_infer and
           has ended before (a)'s timed turns; (c)
           inference_ssl_sr --spatial on prep_infer's 339 x 510 LR, equal to
           the net on the whole image; (d) two StableSR-SSL mini-steps
           (ssl_base.yml's widths, num_res_blocks 1, 256^2, accumulate 2) on
           a (data 1, tp 1) mesh against the same without a mesh: losses
           within TRAIN_LOG_RTOL, gradients within TRAIN_GRAD_REL_L2, the
           update within 2.2 lr; K1 and K2 launched
19. kernels one line per ported kernel (K1's float32 and bf16 stream + store
           modes each, the bf16 store's stream kernel, K2's float32 and bf16
           kernels each), launches on its
           main paths, error against the plain
           version, times and the bound

before it a ``wall`` line with each phase's seconds, then the card's name
and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}.  Weights are random from fixed seeds (no
VGG19, UNet, VAE or metric weight file is in the repository).  Needs one CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# rate of the units that do them: K1's fp32 window sums on the CUDA cores;
# K2's matrix products as 3xTF32 on the tensor cores (three TF32 products
# each, as the backward kernels and torch's fp32 SDPA compute them), its
# softmax's elementwise work on the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
# K2's bf16 kernels: one bf16 product on the tensor cores per product.
PEAK_BF16_PER_S = 989e12

MAIN_B, MAIN_GT, SCALE = 16, 128, 4
# The parallel phase (torch.distributed at one rank, NCCL): the ESRGAN-SSL
# train CLI for PAR_ITERS iterations under --launcher none and pytorch, the
# latter resumed to PAR_RESUME_ITERS; a gradient below PAR_GRAD_FLOOR of its
# net's largest is rounding noise; dist_train.sh for PAR_TORCHRUN_ITERS
# iterations (given PAR_TORCHRUN_TIMEOUT seconds); StableSR-SSL mini-steps at
# PAR_DIFF_SIZE^2.
PAR_ITERS, PAR_RESUME_ITERS, PAR_TORCHRUN_ITERS, PAR_TORCHRUN_TIMEOUT = 3, 4, 2, 300
PAR_GRAD_FLOOR, PAR_DIFF_SIZE = 1e-5, 256
# bench.py's ESRGAN-SSL step (bench.py:54-116): batch 24, gt 128; a warm-up
# step, then BENCH_STEPS timed steps, at its bf16 defaults and in float32.
BENCH_B, BENCH_GT, BENCH_STEPS = 24, 128, 3
# ... in turns, on the same two models: host-bound step times move between runs.
BENCH_TURNS = ("bfloat16", "float32", "float32", "bfloat16")

# The TPU kernels K2's backward replaces: upstream's Pallas TPU flash attention
# (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0), whose custom
# VJP ssl_tpu/ops/attention.py:32-39 reaches.
UPSTREAM_DKV = ("jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                "_flash_attention_bwd_dkv (via ssl_tpu/ops/attention.py:32)")
UPSTREAM_DQ = ("jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
               "_flash_attention_bwd_dq (via ssl_tpu/ops/attention.py:32)")

# |x - y| / max(x, y) below which the plain forward's sign(x - y) counts as
# tied: q carries up to ~1e-5 of relative rounding at sigma 0.004 and the
# kernel's inverse maps ~2e-5, so another summation order moves x - y by less.
# With the bf16 q store, a q (or q_sr - q_gt) within TIE_RTOL of its largest
# q of a bf16 rounding boundary counts as tied too: one float32 ulp may round
# it to the next bf16 value, which moves x or y by a bf16 ulp.
TIE_RTOL = 1e-4
# On a generator's SR (``hold_k1(map_error_ties=True)``) two more kinds of
# tie: [x > 1e-10] in b_map = sum_d y [x > 1e-10] counts as tied where
# |x / 1e-10 - 1| <= THRESHOLD_RTOL (there x = exp(-e) inv with e near 23 at
# sigma 0.004, so a relative rounding r of the window sum behind e moves x by
# about 23 r, and r reaches 1e-4 between summation orders; 1e-2 leaves a
# margin); and each pixel's tie band widens by the relative difference of
# K1's inv_sr and inv_gt from the plain ones there, since the backward forms
# x = q inv from the maps it is given (the maps' atol, 1e-6 of their largest
# value, is a large relative error where inv is small).
THRESHOLD_RTOL = 1e-2
# Largest relative L2 error of d_sr with the full mask, where tied signs that
# flip move g_d by 2 g_l1 at their pixel-offsets (2.05e-5 on an H100 at b16,
# 3x128^2, search 25, window 9, sigma 0.004 on smooth images: PERF.md).
D_SR_REL_L2 = 1e-3
# The strict d_sr check (tied pixels out) compares two float32 routes at
# float32's own noise, and the plain one is no truth there.  Where K1 misses it
# against the plain version, and at every hold on BSRGAN-SSL's SR, the plain
# version run in float64 decides (``d_sr_float64``): d_sr through the float64
# backward fed K1's maps may miss the strict bound against the float64 run by
# no more than that backward fed the plain float32 version's maps does (or 1,
# the bound itself), at no more elements.  The float32 backward that both
# routes share misses it by itself on generator SR (PERF.md, section 6), so
# its error is reported and not held.

# The serving path: ssl_base.yml at 512^2 (a 64^2 latent), spaced DDPM.
SERVE_LQ, SERVE_SIZE, SERVE_STEPS, SERVE_REQUESTS = 128, 512, 50, 2
# K2 launches there: per denoising step the UNet's self-attention at ds 1
# and ds 2 (5 each) and the struct-cond encoder's at ds 1 and ds 2 (2 each);
# per request the VAE encoder's and decoder's mid-blocks.  At ds 4 (256
# tokens) and in the cross-attention (77) the plain path runs, as in JAX.
K2_PER_STEP, K2_PER_REQUEST = 14, 2
# K2 launches of one serving request by case of tests/torch_attention_cases.py
SERVE_MIX = {"unet_ds1": 5 * SERVE_STEPS, "struct_ds1": 2 * SERVE_STEPS,
             "unet_ds2": 5 * SERVE_STEPS, "struct_ds2": 2 * SERVE_STEPS, "vae_mid": 2}
# The K2-vs-plain hold end to end: a 256^2 request (a 32^2 latent: 7 K2
# launches per step, 2 per request), 5 steps, TF32 off.  Largest relative
# L2 error of the decoded image between the two routes (PERF.md states it
# before the first run).
E2E_LQ, E2E_STEPS, E2E_K2_LAUNCHES = 64, 5, 5 * 7 + 2
E2E_REL_L2 = 1e-3
# K2's backward against its plain version (flash_attn_bwd_reference and
# autograd through the plain attention): each of dq, dk and dv within this
# relative L2, and elementwise within rtol 1e-3 and an atol of 1e-4 of the
# largest value.  dS = P * (dP - di) subtracts nearly equal numbers where a
# logit barely matters, and the two sides form di in other orders, so single
# elements carry the cancellation's error on the gradient's own scale.
BWD_REL_L2, BWD_RTOL, BWD_ATOL = 1e-4, 1e-3, 1e-4
# The training path: ssl_base.yml at 512^2 (64^2 latent), batch 2.  K2 per
# mini-step: forward with lse in the UNet (10) and the struct-cond encoder
# (4), the no-grad VAE encoder over [gt; lq] (1), the decoder's mid
# attention (1) and its replay under remat (1); backward in all but the
# encoder and the replay.  tests/test_torch_diffusion_config.py counts them
# on the meta device.  The training runs accumulate TRAIN_MINI_STEPS
# mini-steps an update (ssl_base.yml's accumulate_grad_batches 12 cut to 4,
# so that each update costs a third of the mini-steps): diffusion_train's
# one cycle in process, and the training CLI runs of diffusion_bf16,
# diffusion_cli and the zoo phase, through their base file.
TRAIN_B, TRAIN_SIZE, TRAIN_MINI_STEPS = 2, 512, 4
SHIPPED_ACCUMULATE = 12
TRAIN_K2_FWD, TRAIN_K2_BWD = 17, 15
# The K2-vs-plain hold of one mini-step at 256^2 (a 32^2 latent: the
# UNet's and struct-cond encoder's ds-1 attentions and the VAE's mid
# attention are eligible; 5 + 2 with lse, the encoder 1, the decoder 1 and
# its replay 1), TF32 off.  Bounds stated before the first run (PERF.md).
TRAIN_E2E_SIZE, TRAIN_E2E_K2 = 256, {"fwd": 10, "bwd": 8}
TRAIN_LOG_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3
# StableSR-SSL under model.compute_dtype bfloat16 (diffusion_bf16): the UNet
# eps and the VAE decode within BF16_NET_BOUND of float32's largest value
# (the JAX contract, tests/test_diffusion.py:400-480); on the E2E_LQ request
# the bf16 K2 route's relative L2 to the float32 K2 route at most
# BF16_E2E_RATIO times the bf16 plain route's; a mini-step's UNet gradient
# with cosine above BF16_GRAD_COS to float32's on the same batch and draws.
# Serving requests and in-process mini-steps run bf16 and float32 in turns;
# the train CLI with the override runs BF16_CLI_STEPS mini-steps (one update).
BF16_NET_BOUND, BF16_E2E_RATIO, BF16_GRAD_COS = 3e-2, 1.25, 0.98
BF16_TURNS = ("bfloat16", "float32", "float32", "bfloat16")
BF16_CLI_STEPS = TRAIN_MINI_STEPS
# The train and test CLIs on files: CLI_TRAIN GT images of CLI_GT^2 with their
# LQ and masks, read by CLI_WORKERS loader processes, each image CLI_ENLARGE
# times an epoch (dataset_enlarge_ratio) so that the run stays in one epoch, as
# a real set's would (with 1, each iteration would open an epoch and wait for
# its first batch); CLI_ITERS iterations at batch MAIN_B, then --auto_resume to
# CLI_RESUME_ITERS; val pairs of these GT sizes (LQ 48 x 48 and 44 x 36: the
# second is no multiple of 16); the tiled test run's tile and halo.
CLI_TRAIN, CLI_GT, CLI_WORKERS, CLI_ENLARGE = 24, 192, 4, 4
CLI_ITERS, CLI_RESUME_ITERS = 4, 6
CLI_VAL = ((192, 192), (176, 144))
CLI_TILE = (24, 8)
CLI_METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4, "test_y_channel": True},
               "ssim": {"type": "calculate_ssim", "crop_border": 4, "test_y_channel": True}}
# ... the train YAMLs validate with those; the shipped test YAMLs
# (options/test/*/test_*.yml) add LPIPS and DISTS, which the test CLI runs score
TEST_METRICS = dict(CLI_METRICS,
                    lpips={"type": "calculate_lpips", "crop_border": 4, "better": "lower"},
                    dists={"type": "calculate_dists", "crop_border": 4, "better": "lower"})
# The metric suite (metrics phase) on seeded checkpoints at full width in each
# official layout (tests/torch_metric_cases.py; no metric weight file is in the
# repository).  Holds at METRIC_HOLD^2, float32 on the card with TF32 off
# against float64 on the CPU: LPIPS relative; DISTS absolute (1 - a float32
# score near 1, summed over 1,475 channels); FID's pool3 features and the CLIP
# towers' features in relative L2; the CLIP-IQA score absolute.  Each bound
# lies between the sound reading and the control's with TF32 on, some 10 to
# 50 times from each (on an H100: LPIPS 7.0e-8 / 5.3e-5, DISTS 4.2e-8 /
# 4.8e-6, FID 2.6e-7 / 4.9e-4, CLIP visual 9.5e-7 / 1.0e-3, text 1.3e-6 /
# 8.7e-4, CLIP-IQA 5.3e-8 / 4.8e-5; PERF.md).  Times per
# image at each of METRIC_SIZES (512^2 and a DIV2K valid image, 2040 x 1356,
# the largest the shipped test sets give), METRIC_ITERS calls after a warm-up;
# FID over METRIC_FID_IMAGES PNGs of 512^2 at batch METRIC_FID_BATCH.
METRIC_HOLD, METRIC_ITERS = 256, 2
METRIC_SIZES = ((512, 512), (1356, 2040))
METRIC_FID_IMAGES, METRIC_FID_BATCH = 16, 8
METRIC_BOUNDS = {"lpips": 1e-6, "dists": 5e-7, "fid_pool3": 1e-5, "clip_visual": 3e-5,
                 "clip_text": 3e-5, "clipiqa": 1.5e-6}


# RealESRGAN-SSL (options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml):
# RE_TRAIN GT sub-images of RE_GT_IMG^2 (the YAML's multiscale_HR_sub_512),
# cropped to RE_CROP (crop_pre), batch RE_B, RE_WORKERS loader processes;
# the training-pair pool cut from the YAML's 180 slots to RE_QUEUE so that
# iterations 3-4 take its full branch (180 would fill for 15 iterations);
# each image RE_ENLARGE times an epoch so that the 6 iterations stay in one
# epoch, as a real set's would; RE_ITERS iterations, then --auto_resume to
# RE_RESUME_ITERS; a BlindLR-style test set of RE_TEST_GT GT images of
# RE_TEST_SIZE, each with the LQ variants of RE_VARIANTS.
RE_TRAIN, RE_GT_IMG, RE_CROP, RE_B, RE_WORKERS = 24, 512, 400, 12, 6
RE_QUEUE, RE_ENLARGE, RE_ITERS, RE_RESUME_ITERS = 24, 3, 4, 6
RE_TEST_GT, RE_TEST_SIZE, RE_VARIANTS = 2, (256, 192), ("bicubic", "area_noise")
# RealESRGAN-SSL's host mode (degradation_device: false) after the device
# runs: RE_HOST_ITERS iterations at batch RE_B with the pool of RE_QUEUE pairs.
RE_HOST_ITERS = 3
# ... which crops the degraded pairs to the train set's gt_size (the YAML's).
RE_HOST_GT = 256
# StableSR-SSL training through its CLI (ssl_tpu_torch.diffusion.main --train):
# DC_TRAIN GT PNGs of TRAIN_SIZE^2 (the size of the shipped
# multiscale_HR_sub_512), crop TRAIN_SIZE, batch TRAIN_B, DC_WORKERS loader
# processes, TRAIN_MINI_STEPS mini-steps an update; DC_STEPS mini-steps (one
# update) with a log line every DC_LOG and checkpoints and previews every
# DC_SAVE, then --resume auto to DC_RESUME_STEPS (a second update and
# checkpoint); the test
# CLI on the two checkpoints, one (4 SERVE_LQ)^2 request of DC_TEST_STEPS
# steps each (the serve phase times SERVE_STEPS).
DC_TRAIN, DC_WORKERS = 24, 4
DC_STEPS, DC_LOG, DC_SAVE, DC_RESUME_STEPS, DC_TEST_STEPS = 4, 2, 4, 8, 10
# The cfw phase: StableSR's stage 2 at the reference's CFW widths, 512^2 crops,
# batch 2, NLayerDiscriminator at its default widths.  K2 a step: the
# encoder's mid attention on the LQ (no grad), the decoder's, and its replay
# under remat (forward), the decoder's backward.
CFW_WIDTHS = {"ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2, "num_fuse_block": 2}
CFW_SIZE, CFW_B, CFW_GT, CFW_DUMP_STEPS = 512, 2, 4, 4
CFW_CLI_STEPS, CFW_RESUME_STEPS, CFW_TIME_STEPS = 2, 3, 2
CFW_TEST_LQ, CFW_TEST_STEPS = 2, 10
CFW_OVERRIDES = ["vae.use_flash_attention=true", "network_d.type=NLayerDiscriminator",
                 "train.log_every=1"]
CFW_K2 = {"fwd": 3, "bwd": 1}
CFW_KERNELS = ("flash_attn_fwd_d512", "flash_attn_bwd_p_ds", "flash_attn_bwd_dkv_mm",
               "flash_attn_bwd_dq_mm")
CFW_TURNS = ("bfloat16", "float32", "float32", "bfloat16")
CFW_GRAD_FLOOR, CFW_NOISE_SHARE = 1e-5, 0.05
# The zoo phase: the gather route (impl: scan) against K1's dense route at the
# ESRGAN-SSL step's shape (b16 3 x MAIN_GT^2 pictures with real edge masks,
# every edge within the capacity), selfsim1_opt.softmax there, every key of the
# strategy zoo through ssl_loss at b ZOO_B 3 x ZOO_SIZE^2 (mask stride 3,
# capacity ZOO_CAP, the zoo's default options: tiles 16, search / area 25,
# window 9), PerceptualSimLoss with both self-similarity terms (held at
# ZOO_SIZE^2, timed at TRAIN_SIZE^2 b TRAIN_B), and ZOO_CLI_STEPS mini-steps
# (two updates) of the StableSR-SSL training CLI with ZOO_CLI_STRATEGY on
# diffusion_cli_fixtures' data.  Card against CPU in float64 within
# ZOO_F64_RTOL (relative on the losses, relative L2 on d_sr); TF32 off.
ZOO_B, ZOO_SIZE, ZOO_CAP, ZOO_F64_RTOL = 2, 128, 2048, 1e-10
ZOO_CLI_STEPS, ZOO_CLI_STRATEGY = 2 * TRAIN_MINI_STEPS, "areaarea_mask_nonlocal_cuda_v1"
# the CPU's float64 references run in this many processes of this many threads
# (from the script's start, beside the build, the metrics phase and the phases
# before the zoo's: 3 of the card machine's 8 cores, as nvcc takes 3)
ZOO_REF_WORKERS, ZOO_REF_THREADS = 3, 1
# each key's float32 ms: CUDA events over this many calls after a first one
ZOO_TIME_ITERS = 1
# The six bicubic GAN-SSL recipes (options/train/<recipe>/train_<recipe>_bicubic_x4.yml):
# the ESRGAN-SSL YAML's values (``shipped_opt``) but for each recipe's model,
# its G at the shipped widths, its D, its own losses (``train``) and nets
# (``opt``); ``losses`` are the logged keys it adds; ``hold_k1`` marks the
# transformer G's whose SR holds K1 against its plain version.  Each runs
# RC_ITERS iterations at batch MAIN_B on the cli_fixtures data with
# RC_WORKERS loader processes (the YAMLs ship 32 and 8), then --auto_resume
# to RC_RESUME_ITERS.
RC_D = {"type": "UNetDiscriminatorSN", "num_feat": 64}
RECIPES = {
    "LDLSSL": {"model": "LDLSSLModel", "opt": {
        "network_g": {"type": "RRDBNet", "num_feat": 64, "num_block": 23, "num_grow_ch": 32},
        "network_d": RC_D}, "train": {"artifacts_opt": {"type": "L1Loss", "loss_weight": 1.0}},
        "losses": ("l_g_artifacts",), "hold_k1": False},
    "BebyGANSSL": {"model": "BebyGANSSLModel", "opt": {
        "network_g": {"type": "RRDBBebyGANNet", "nf": 64, "nb": 23, "gc": 32},
        "network_d": RC_D}, "train": {
        "bbl_opt": {"loss_weight": 1.0, "alpha": 1.0, "beta": 1.0, "ksize": 3, "stride": 3},
        "back_projection_opt": {"loss_weight": 1.0}},
        "losses": ("l_g_bbl", "l_g_bp"), "hold_k1": False},
    "SPSRSSL": {"model": "SPSRSSLModel", "opt": {
        "network_g": {"type": "SPSRNet", "nf": 64, "nb": 23, "gc": 32, "upscale": 4},
        "network_d": RC_D, "network_d_grad": RC_D}, "train": {
        "gradient_pixel_opt": {"loss_weight": 1.0}, "gradient_branch_opt": {"loss_weight": 0.5}},
        "losses": ("l_g_grad_pix", "l_g_grad_branch", "l_g_gan_grad", "l_d_real_grad",
                   "l_d_fake_grad"), "hold_k1": False},
    "RankSRGANPISSL": {"model": "RankSRGANSSLModel", "opt": {
        "network_g": {"type": "RankSRGANSRResNet", "nf": 64, "nb": 16, "upscale": 4},
        "network_d": {"type": "Discriminator_VGG_296", "nf": 64},
        "network_r": {"type": "Ranker_VGG12_296", "nf": 64}},
        "train": {"rank_opt": {"loss_weight": 0.03, "R_bias": 0.0}},
        "losses": ("l_g_rank",), "hold_k1": False},
    "SwinIRGANSSL": {"model": "SwinIRGANSSLModel", "opt": {
        "network_g": {"type": "SwinIR", "upscale": 4, "window_size": 8, "depths": [6, 6, 6, 6],
                      "embed_dim": 180, "num_heads": [6, 6, 6, 6], "upsampler": "pixelshuffle"},
        "network_d": RC_D}, "train": {}, "losses": (), "hold_k1": True},
    "ELANGANSSL": {"model": "ELANGANSSLModel", "opt": {
        "network_g": {"type": "ELAN", "scale": 4, "m_elan": 36, "c_elan": 180,
                      "window_sizes": [4, 8, 16]},
        "network_d": RC_D}, "train": {}, "losses": (), "hold_k1": True},
}
RC_LOSSES = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real", "l_d_fake")
RC_WORKERS, RC_ITERS, RC_RESUME_ITERS = 4, 2, 3
# the recipes whose test CLI also runs in tiles (the windowed transformer's
# padding to its window); the others run whole only
RC_TILED = ("SwinIRGANSSL",)
# The KAIR/BSRGAN GAN-SSL family (options/train/<recipe>/train_<recipe>_DF2K_OST_x4.json,
# KAIR-schema files through utils/kair_options.py): KR_TRAIN GT PNGs of KR_GT_IMG^2
# (at least the largest batch, each larger than H_size 256), cropped to the file's
# H_size (``gt``) and degraded on the host by the BSRGAN chain in the file's
# dataloader_num_workers processes (6), at the file's batch (``batch``; a cut only
# where the card cannot hold it), with cv2 hidden; each image KR_ENLARGE times an
# epoch so that the run stays in one epoch; KR_ITERS iterations with a save, then
# --auto_resume to KR_RESUME_ITERS; the test CLI with the shipped test YAML's model
# and G (``test``: transcribed, so that no yaml is needed; held against the YAML
# where yaml imports) on the realesrgan phase's kind of BlindLR set.  ``force``: the
# SwinIR file's own netG widths, which kair_to_opt drops (ROADMAP.md section 3), so
# that it trains the G its test YAML loads.  K1 is held on BSRGAN-SSL's SR of
# KR_HOLD training pairs with the stride-3 mask, for each of KR_HOLD_SEEDS; the kernel
# phase holds and times it at each recipe's shape (``batch`` x ``gt``^2).
KR_TRAIN, KR_GT_IMG, KR_ENLARGE, KR_HOLD, KR_HOLD_SEEDS = 64, 288, 4, 16, (0, 1, 2)
KR_ITERS, KR_RESUME_ITERS = 2, 3
KR_SWINIR = {"type": "SwinIR", "upscale": 4, "in_chans": 3, "img_size": 64, "window_size": 8,
             "img_range": 1.0, "depths": [6, 6, 6, 6, 6, 6], "embed_dim": 180,
             "num_heads": [6, 6, 6, 6, 6, 6], "mlp_ratio": 2, "upsampler": "pixelshuffle",
             "resi_connection": "1conv"}
KAIR = {
    "BSRGANSSL": {"batch": 48, "gt": 256, "force": [], "test": {
        "model_type": "BSGRANTestModel", "network_g": {
            "type": "BSRGANRRDBNet", "in_nc": 3, "out_nc": 3, "nf": 64, "nb": 23, "gc": 32,
            "sf": 4}}},
    "ELANGANSSL_BSRGAN": {"batch": 64, "gt": 192, "force": [], "test": {
        "model_type": "BSGRANTestModel", "network_g": {
            "type": "ELAN", "scale": 4, "img_range": 255.0, "colors": 3,
            "window_sizes": [4, 8, 16], "m_elan": 36, "c_elan": 180, "n_share": 0,
            "r_expand": 2, "rgb_mean": [0.4488, 0.4371, 0.404]}}},
    "SwinIRGANSSL_BSRGAN": {"batch": 16, "gt": 256, "force": [
        "network_g:embed_dim=180", "network_g:depths=[6, 6, 6, 6, 6, 6]",
        "network_g:num_heads=[6, 6, 6, 6, 6, 6]"], "test": {
        "model_type": "BSGRANTestSwinIRModel", "network_g": KR_SWINIR}},
}
# The degradation hold, card against CPU, TF32 off: each stage is float32
# convolutions, resizes and 8x8 DCTs summed in other orders, so the output
# may move by one uint8 level where a value, or a JPEG coefficient, lies
# within rounding of a half-integer; at most RE_TIE_SHARE of the values may.
RE_TIE_SHARE = 1e-3
# The prep_infer phase, the path a user walks from HR images to SR images:
# PI_HR HR PNGs of PI_HR_SIZE (h, w) made on the card -> generate_bicubic_lr
# --mod 12 --gt_output (GT 396 x 516, LR 99 x 129) -> generate_mask -> the
# ESRGAN-SSL train CLI at the shipped YAML's values (batch MAIN_B, gt MAIN_GT,
# CLI_WORKERS loader processes) for PI_ITERS iterations -> the inference
# entry points on the first PI_INFER LR images, whole and in PI_TILE (tile,
# halo) tiles -> back_projection on PI_GEN of their SR; one DIV2K-valid HR
# (PI_DIV2K) through generate_bicubic_lr and the entry points; PI_GEN HR
# through generate_realesrgan_bsrgan_lr (GENERATE_OPT).  Each entry point's
# first image on the card with TF32 off against the same CLI with --device
# cpu: within one level on at most PI_LEVEL_SHARE of the values.  The
# registry hold: each arch of PI_REGISTRY at its default width (input shape
# given), forward and backward on the card and on the CPU, TF32 off, against
# the CPU in float64: in float64 the output, input gradient and parameter
# gradients within PI_REG_F64; in float32 the output within PI_REG_REL_L2.
PI_HR, PI_HR_SIZE, PI_ITERS, PI_INFER, PI_GEN = 24, (400, 520), 2, 8, 4
PI_TILE = (100, 16)
PI_DIV2K = (1356, 2040)
PI_STASH: dict = {}         # the DIV2K-size LR PNG, which the parallel phase restores again
PI_LEVEL_SHARE, PI_REG_REL_L2, PI_REG_F64 = 1e-3, 1e-4, 1e-10
# options/test/SwinIRGANSSL/test_SwinIRGANSSL_bicubic_x4.yml's network_g
PI_SWINIR = {"in_chans": 3, "img_size": 64, "window_size": 8, "img_range": 1.0,
             "depths": [6] * 6, "embed_dim": 180, "num_heads": [6] * 6, "mlp_ratio": 2,
             "upsampler": "pixelshuffle", "resi_connection": "1conv"}
PI_REGISTRY = {"UNetDiscriminatorSNv1": (2, 3, 128, 128), "MOD": (2, 3, 64, 64),
               "Discriminator_VGG_192": (2, 3, 192, 192),
               "DiscriminatorSN_VGG_192": (2, 3, 192, 192),
               "NLayerDiscriminator": (2, 3, 128, 128), "RRDBPSNet": (1, 3, 24, 24),
               "RRDBMeanNet": (1, 3, 24, 24)}
# options/generate/generate_RealESRGAN+BSRGAN_LR.yml as a dict (its datasets
# block is the phase's folder)
GENERATE_OPT = {
    "manual_seed": 0, "scale": 4,
    "RealESRGAN": {
        "scale": 4, "use_second_order_prob": 0.2, "resize_prob": [0.1, 0.85, 0.05],
        "resize_range": [0.8, 1.1], "gaussian_noise_prob": 0.5, "noise_range": [1, 8],
        "poisson_scale_range": [0.05, 0.5], "gray_noise_prob": 0.2, "jpeg_range": [87, 95],
        "blur_kernel_size_min": 1, "blur_kernel_size_max": 3, "kernel_list": ["iso", "aniso"],
        "kernel_prob": [0.7, 0.3], "sinc_prob": 0.01, "blur_sigma": [0.1, 0.4],
        "betag_range": [0.1, 0.7], "betap_range": [0.1, 0.7], "second_blur_prob": 0.8,
        "resize_prob2": [0.1, 0.85, 0.05], "resize_range2": [0.8, 1.1],
        "gaussian_noise_prob2": 0.5, "noise_range2": [0, 5], "poisson_scale_range2": [0, 0.4],
        "gray_noise_prob2": 0.2, "jpeg_range2": [90, 95], "blur_kernel_size_min2": 1,
        "blur_kernel_size_max2": 2, "kernel_list2": ["iso", "aniso"], "kernel_prob2": [0.7, 0.3],
        "sinc_prob2": 0.01, "blur_sigma2": [0.1, 0.3], "betag_range2": [0.1, 0.5],
        "betap_range2": [0.1, 0.5], "final_sinc_prob": 0.1},
    "BSRGAN": {"sf": 4, "add_blur_kernel_range": [0, 4],
               "downsample2_resize_range": [0.75, 1.0], "add_gaussian_noise_range": [1, 10],
               "add_jpeg_noise_range": [85, 95]},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# what fail() stops before the script exits (the zoo's reference processes)
STOP = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    for stop in STOP:
        stop()
    sys.exit(1)


def shipped_opt(batch: int) -> dict:
    """options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml as a dict (the
    card's machine has no yaml), with the batch of this run."""
    return {
        "name": "ESRGANSSL_bicubic_x4", "model_type": "ESRGANSSLModel", "scale": SCALE,
        "num_devices": 1, "manual_seed": 0,
        "datasets": {"train": {"gt_size": MAIN_GT, "batch_size_per_gpu": batch}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 64,
                      "num_block": 23, "num_grow_ch": 32},
        "network_d": {"type": "VGGStyleDiscriminator", "num_in_ch": 3, "num_feat": 64,
                      "input_size": 128},
        "path": {"pretrain_network_g": None, "param_key_g": "params", "strict_load_g": True},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 25,
                        "sigma": 0.004, "kernel_size_window": 9, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [50000, 100000, 200000, 300000],
                          "gamma": 0.5},
            "total_iter": 400000, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": {"conv5_4": 1},
                               "vgg_type": "vgg19", "use_input_norm": True, "range_norm": False,
                               "perceptual_weight": 1.0, "style_weight": 0, "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0,
        },
    }


def smooth_case(b, h, seed, density):
    """Smooth images with a noisy copy: the regime where q is far from 0.
    Values stay within about [-0.1, 1.25], the range of the SR data; image
    i is the pattern moved by 0.1 (i // 3) and scaled by 0.9 + 0.1 (i % 3),
    so the first two are those of tests/torch_ssg_cases.py."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:h] / h

    def base(shift):
        x = xx + shift
        return np.stack([np.sin(6 * yy) + np.cos(5 * x), yy * x, np.cos(8 * (yy + x))]) * 0.3 + 0.5

    gt = np.stack([base(0.1 * (i // 3)) * (0.9 + 0.1 * (i % 3)) for i in range(b)])
    gt = gt.astype(np.float32)
    sr = (gt + rng.randn(b, 3, h, h) * 0.1).astype(np.float32)
    mask = (rng.rand(b, h, h) < density).astype(np.float32)
    return sr, gt, mask


def edge_case(b, h, seed):
    """The RealESRGAN-SSL step's K1 inputs: GT pictures made on the card
    (``smooth_picture``: smooth fields, sharp-edged blocks, light noise), their
    real edge masks (``edge_mask_torch``, threshold 20, as generate_mask
    writes them) and SR = GT + N(0, 0.1^2)."""
    import torch
    from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gt = torch.stack([smooth_picture(h, h, gen, "cuda") for _ in range(b)]) / 255
    mask = edge_mask_torch(gt, 20.0)[:, 0]
    sr = gt + 0.1 * torch.randn(gt.shape, generator=gen, device="cuda")
    return tuple(t.contiguous().cpu().numpy() for t in (sr, gt, mask))


def kair_case(b, h, seed):
    """``edge_case`` with the KAIR recipes' stride-3 lattice on the mask, as
    BSRGANSSLModel gives it to K1."""
    import numpy as np
    sr, gt, mask = edge_case(b, h, seed)
    yy, xx = np.mgrid[0:h, 0:h]
    return sr, gt, mask * (yy % 3 == xx % 3).astype(np.float32)


def bench_case(b, h, seed, density):
    """bench.py:122-126's inputs: uniform images and a mask of the given density."""
    import numpy as np
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, 3, h, h).astype(np.float32)
    sr = rng.rand(b, 3, h, h).astype(np.float32)
    mask = (rng.rand(b, h, h) < density).astype(np.float32)
    return sr, gt, mask


def k1_operations(b, c, h, w, search, generalization=True) -> float:
    """fp32 operations K1's function needs, counting each exp/log as one:
    per image, pixel and offset the windowed SSD with O(1) running box-sums
    (3c for the squared differences, 1 for -C2, 4 for the two box-sums, 1 for
    +box9(C2)) and the epilogue (2 scalings, 1 exp) = 3c + 9; each sweep adds
    one accumulate; sweep 2 adds 16 for the loss terms and a/b maps."""
    per_q = 3 * c + 9
    sweeps = 2 if generalization else 1
    return float(b * h * w * search * search * (sweeps * 2 * (per_q + 1) + 16))


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check_close(name, got, ref, rtol, atol=0.0):
    import torch
    got, ref = got.detach().double(), ref.detach().double()
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        fail(f"{name}: {int(bad.sum())} elements off (rtol {rtol}, atol {atol}); first at "
             f"{i}: {float(got.flatten()[i])} vs {float(ref.flatten()[i])}")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    """Compile every kernel of the port, one nvcc process per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    from ssl_tpu_torch.ops import cuda_build
    names = ("ssg_loss_fwd", "flash_attn_fwd", "flash_attn_bwd")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda n: cuda_build.build(n)[1], names)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": list(names),
          "ptxas": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})


def near_ties(sr, gt, ref, cfg, band=0.0):
    """The plain forward's pixel-offsets at which sign(x - y), or [x > 1e-10],
    lies within rounding of the other side: |x - y| <= TIE_RTOL max(x, y), or
    x within TIE_RTOL of 1e-10 (TIE_RTOL + ``band``, a (b, h, w) map, where
    given).  Another summation order (the kernel's) may take either side
    there, which moves a_map by up to 2x and d_sr through the backward's g_d.
    ``ref`` is the plain forward's output.  Returns the (b, h, w) pixels with
    any such offset, the number of tied pixel-offsets, a_map's lower and
    upper bounds with every tied sign free in [-1, 1], sum_d x, and sum_d y
    over the offsets whose x lies within THRESHOLD_RTOL (or the band) of
    1e-10 (what b_map may move by); and with the bf16 q store, what x and y
    may move by over the offsets whose stored values are tied at a bf16
    rounding boundary (sum_d of a bf16 ulp times inv), and how many are."""
    import torch
    from ssl_tpu_torch.ops.ssg import BF16, _context, _q_decode, _q_maps
    b, c = sr.shape[:2]
    inv_sr, inv_gt = ref[3], ref[4]
    ctx = _context(torch.cat([sr, gt]), cfg)
    norm = c * float(cfg.window) ** 2
    tied_px = torch.zeros(inv_sr.shape, dtype=torch.bool, device=sr.device)
    n_tied = torch.zeros((), device=sr.device)
    n_bf16 = torch.zeros((), device=sr.device)
    a_fixed, a_free, x_sum, b_free, x16, y16 = (torch.zeros_like(inv_sr) for _ in range(6))
    rtol = TIE_RTOL + band
    store16 = cfg.q_store_dtype == BF16
    for s in range(cfg.search ** 2):
        q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
        dx = dy = 0.0
        if store16:
            slack = rtol * torch.maximum(q_sr, q_gt)
            (t1, u1), (t2, u2) = (bf16_tie(v, slack) for v in (q_sr, q_sr - q_gt))
            dx, dy = t1 * u1 * inv_sr, (t1 * u1 + t2 * u2) * inv_gt
            x16 += dx
            y16 += dy
            n_bf16 += (t1 | t2).sum()
            q_sr, q_gt = _q_decode(q_sr, q_gt, cfg)
        x, y = q_sr * inv_sr, q_gt * inv_gt
        top = torch.maximum(x, y)
        tied_px |= (((x - y).abs() <= rtol * top) & (top > 0)) | \
            ((x - 1e-10).abs() <= rtol * 1e-10)
        # a bf16 tie moves x by dx and y by dy: sign(x - y) may flip with them
        tie = ((x - y).abs() <= rtol * top + dx + dy) & (top > 0)
        n_tied += tie.sum()
        a_fixed += torch.sign(x - y) * x * ~tie
        a_free += x * tie
        x_sum += x
        b_free += y * ((x - 1e-10).abs() <= torch.clamp(torch.as_tensor(rtol), min=THRESHOLD_RTOL)
                       * 1e-10 + dx)
    return (tied_px, int(n_tied), a_fixed - a_free, a_fixed + a_free, x_sum, b_free, x16, y16,
            int(n_bf16))


def bf16_tie(v, slack):
    """Whether each value of ``v`` lies within ``slack`` of a bf16 rounding
    boundary (the midpoint of two neighbouring bf16 values), and its bf16
    ulp there (what a rounding to the other side moves it by)."""
    import torch
    a = v.abs()
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-38))) - 7)
    mid = torch.floor(a / ulp) * ulp + ulp / 2
    return ((a - mid).abs() <= slack) & (a > 0), ulp


def hold_k1(name, sr, gt, mask, cfg, map_rtol, fwd, map_error_ties=False, float64=False,
            stored=False):
    """Hold the forward ``fwd`` (K1's wrapper) and d_sr through the autograd
    function against the plain version; fail() at the first disagreement.

    Tolerances: count exact; l1 rel 1e-4 and kl rel 1e-3 (the contract of
    tests/test_ssg_pallas.py:30-31, sums taken in another order); inv_sr,
    inv_gt and b_map ``map_rtol`` (1e-5; 1e-4 at sigma 0.004 on smooth images,
    where S_d = box9(C2) + rect(D - C2) cancels a box of ~70 and q carries
    ~1e-5 of relative rounding: tests/torch_ssg_cases.py) with an atol of 1e-6
    of the map's largest value (elements that small are sums of cancelling
    terms).  a_map = sum_d sign(x - y) x: inside the plain version's bounds
    with the tied signs free (``near_ties``), widened by map_rtol sum_d x, the
    rounding of the x it sums.  d_sr: with the tied pixels taken out of the
    mask, rtol 1e-4 (tests/test_ssg_pallas.py:48) with an atol of 1e-7 or 1e-6
    of the gradient's largest value, whichever is larger (the backward's terms
    inv g_d - inv^2 T cancel, so d_sr carries the maps' rounding on its own
    scale), and where K1 misses that, or always with ``float64``, the plain
    version run in float64 decides (``d_sr_float64``); with the full mask, a
    relative L2 error of at most D_SR_REL_L2.  ``cfg``'s bf16 knobs pick
    K1's mode and the plain version's; ``stored``: the stored route's
    backward.  With the bf16 q store, x and y may also move by a bf16 ulp at
    the offsets ``near_ties`` finds tied at a rounding boundary: a_map and
    b_map by those sums, l1 by their masked sum, and the pixels where they
    exceed the maps' atol leave the strict d_sr check.
    With ``map_error_ties`` (a generator's SR) the ties are those of
    THRESHOLD_RTOL's comment: each pixel's band widens by the inv maps'
    measured relative error there, b_map may also move by sum_d y over the
    offsets whose x lies within THRESHOLD_RTOL of 1e-10, and the pixels where
    it does leave the mask of the strict d_sr check too.

    Returns the largest absolute differences and what the ties did."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import ssl_loss_dense_bwd, ssl_loss_sums_reference

    got = fwd(sr, gt, mask, cfg)
    ref = ssl_loss_sums_reference(sr, gt, mask, cfg)
    if float(got[2]) != float(ref[2]):
        fail(f"{name}: count {float(got[2])} vs {float(ref[2])}")
    band = ((got[3] / ref[3] - 1).abs() + (got[4] / ref[4] - 1).abs()) if map_error_ties \
        else 0.0
    tied, n_tied, a_lo, a_hi, x_sum, b_free, x16, y16, n_bf16 = near_ties(sr, gt, ref, cfg,
                                                                           band)
    errs = {"l1": check_close(f"{name} l1", got[0], ref[0], 1e-4,
                              float((mask * (x16 + y16)).sum())),
            "kl": check_close(f"{name} kl", got[1], ref[1], 1e-3), "count": 0.0}
    for i, key in ((3, "inv_sr"), (4, "inv_gt")):
        errs[key] = check_close(f"{name} {key}", got[i], ref[i], map_rtol,
                                1e-6 * float(ref[i].abs().max()))
    b_diff = (got[6] - ref[6]).abs()
    strict = map_rtol * ref[6].abs() + 1e-6 * float(ref[6].abs().max())
    b_allow = y16 + (b_free if map_error_ties or cfg.q_store_dtype == "bfloat16" else 0.0)
    b_out = b_diff > strict + b_allow
    if bool(b_out.any()):
        i = int(b_out.flatten().nonzero()[0])
        fail(f"{name} b_map: {int(b_out.sum())} elements off beyond the ties' allowance; "
             f"first at {i}: {float(got[6].flatten()[i])} vs {float(ref[6].flatten()[i])} "
             f"(allowance {float(b_allow.flatten()[i]) if torch.is_tensor(b_allow) else 0.0})")
    errs["b_map"] = float(b_diff.max())
    tied = tied | (b_diff > strict)
    slack = map_rtol * x_sum + x16
    outside = (got[5] < a_lo - slack) | (got[5] > a_hi + slack)
    if bool(outside.any()):
        i = int(outside.flatten().nonzero()[0])
        fail(f"{name} a_map: {int(outside.sum())} elements outside the plain version's bounds "
             f"with tied signs free; first at {i}: {float(got[5].flatten()[i])} not in "
             f"[{float(a_lo.flatten()[i])}, {float(a_hi.flatten()[i])}]")
    a_diff = (got[5] - ref[5]).abs()
    a_off = a_diff > map_rtol * ref[5].abs() + 1e-6 * float(ref[5].abs().max())
    errs["a_map"] = float(a_diff.max())
    if cfg.q_store_dtype == "bfloat16":   # the maps moved by a bf16 tie (inside the bounds above)
        tied = tied | a_off

    one = torch.ones((), device=sr.device)

    def d_sr(m):
        """(autograd through fwd, the backward fed the plain maps) for mask m."""
        s = sr.clone().requires_grad_(True)
        l1, kl, _ = ssg_cuda.ssl_loss_sums(s, gt, m, cfg, stored)
        (l1 + kl).backward()
        return s.grad, ssl_loss_dense_bwd(sr, gt, m, ref[3], ref[4], one, one, cfg,
                                          ref[5], ref[6], stored=stored)

    got_d, ref_d = d_sr(mask * ~tied)
    atol = max(1e-7, 1e-6 * float(ref_d.abs().max()))
    off = (got_d - ref_d).abs() > atol + 1e-4 * ref_d.abs()
    judged = {"d_sr_off_strict": int(off.sum())}
    if float64 or bool(off.any()):
        judged.update(d_sr_float64(name, sr, gt, mask * ~tied, cfg, stored, got, ref, got_d,
                                   ref_d))
    got_d, ref_d = d_sr(mask)
    d_diff = got_d - ref_d
    rel_l2 = float(d_diff.norm() / ref_d.norm().clamp_min(1e-30))
    if rel_l2 > D_SR_REL_L2:
        fail(f"{name} d_sr: relative L2 error {rel_l2} above {D_SR_REL_L2}")
    d_off = d_diff.abs() > 1e-4 * ref_d.abs() + max(1e-7, 1e-6 * float(ref_d.abs().max()))
    errs["d_sr"] = float(d_diff.abs().max())
    ties = {"tied_pixel_offsets": n_tied,
            "tied_share": n_tied / (mask.numel() * cfg.search ** 2),
            "pixels_with_a_tie": int(tied.sum()),
            "masked_pixels_with_a_tie": int((tied & (mask > 0)).sum()),
            "a_map_off_elementwise": int(a_off.sum()),
            "a_map_off_at_untied_pixels": int((a_off & ~tied).sum()),
            "a_map_max_abs_at_tied_pixels": float((a_diff * tied).max()),
            "a_map_max_abs_at_untied_pixels": float((a_diff * ~tied).max()),
            "a_map_max_abs_over_sum_x_at_untied_pixels": float((a_diff * ~tied / x_sum).max()),
            "d_sr_rel_l2": rel_l2, "d_sr_off_elementwise_share": float(d_off.float().mean()),
            "d_sr_max_abs": float(ref_d.abs().max())}
    ties.update(judged)
    if cfg.q_store_dtype == "bfloat16":
        ties.update(bf16_tied_pixel_offsets=n_bf16,
                    pixels_with_a_bf16_tie=int((x16 + y16 > 0).sum()))
    if map_error_ties:
        ties.update(b_map_off_strict=int((b_diff > strict).sum()),
                    pixels_with_a_threshold_tie=int((b_free > 0).sum()),
                    inv_rel_err_max=float(band.max()),
                    pixels_band_over_tie_rtol=int((band > TIE_RTOL).sum()))
    return errs, ties


def hold_k1_wide(name, sr, gt, mask, cfg) -> dict:
    """K1 on a wide-range SR (``flax_variance_init``'s, std ~9) against the
    plain version run in float64, which is the truth there (the plain float32
    version's window sums cancel boxes of C2 near 1e5 and its inverse maps lie
    ~1e-2 off): the count exact, inv_sr and inv_gt within rtol 1e-4 (atol 1e-6
    of the largest value), and d_sr (mask with the float64 run's tied pixels
    out) by ``d_sr_float64``'s criterion.  Returns each route's errors."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import ssl_loss_dense_bwd, ssl_loss_sums_reference
    got = ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg)
    ref = ssl_loss_sums_reference(sr, gt, mask, cfg)
    sr64, gt64 = sr.double(), gt.double()
    f64 = ssl_loss_sums_reference(sr64, gt64, mask.double(), cfg)
    if float(got[2]) != float(f64[2]):
        fail(f"{name}: count {float(got[2])} vs {float(f64[2])}")
    out = {}
    for route, maps in (("k1", got), ("plain_f32", ref)):
        for i, key in ((0, "l1"), (1, "kl"), (3, "inv_sr"), (4, "inv_gt")):
            out[f"{route}_{key}_max_rel_err"] = float(
                ((maps[i].double() - f64[i]).abs() / f64[i].abs()).max())
    for i, key in ((3, "inv_sr"), (4, "inv_gt")):
        check_close(f"{name} {key} against float64", got[i], f64[i], 1e-4,
                    1e-6 * float(f64[i].abs().max()))
    m = mask * ~near_ties(sr64, gt64, f64, cfg)[0]
    one = torch.ones((), device=sr.device)

    def d32(maps):
        return ssl_loss_dense_bwd(sr, gt, m, maps[3], maps[4], one, one, cfg, maps[5], maps[6])
    out.update(d_sr_float64(name, sr, gt, m, cfg, False, got, ref, d32(got), d32(ref)))
    out.update(sr_range=[float(sr.min()), float(sr.max())], sr_std=float(sr.std()))
    return out


def flax_variance_init(net, generator) -> None:
    """The JAX package's RRDB init: N(0, 1 / fan_in) (flax's default) outside
    the dense blocks, the dense blocks as the reference draws them; a
    full-width RRDB net's SR of a [0, 1] input then has a std of ~9."""
    from ssl_tpu_torch.archs.arch_util import normal_init_
    from ssl_tpu_torch.archs.rrdbnet_arch import ResidualDenseBlock
    normal_init_(net, generator)
    for m in net.modules():
        if isinstance(m, ResidualDenseBlock):
            normal_init_(m, generator, gain=2.0, scale=0.1)


def d_sr_float64(name, sr, gt, m, cfg, stored, got, ref, got_d, ref_d) -> dict:
    """The float64 criterion on d_sr (mask ``m``): the plain forward and
    backward run again in float64 on the same inputs, and the float64
    backward is also fed K1's maps (``got``) and the plain float32 version's
    (``ref``).  Through it, K1's d_sr may miss the strict bound (rtol 1e-4,
    atol 1e-6 of the largest value) against the float64 d_sr by no more than
    the plain version's does, or 1, and at no more elements; else fail().
    Returns those two routes' worst errors in units of the strict bound and
    their elements off it, and the same for the float32 d_sr of each route
    (``got_d``, ``ref_d``) and of the float32 backward fed the float64 maps
    (the backward's own error, which both routes share)."""
    import torch
    from ssl_tpu_torch.ops.ssg import ssl_loss_dense_bwd, ssl_loss_sums_reference
    sr64, gt64, m64 = (t.double() for t in (sr, gt, m))
    fwd64 = ssl_loss_sums_reference(sr64, gt64, m64, cfg)
    one = torch.ones((), dtype=torch.float64, device=sr.device)

    def bwd64(maps):
        return ssl_loss_dense_bwd(sr64, gt64, m64, *(maps[i].double() for i in (3, 4)), one,
                                  one, cfg, *(maps[i].double() for i in (5, 6)), stored=stored)
    d64 = bwd64(fwd64)
    bound = max(1e-7, 1e-6 * float(d64.abs().max())) + 1e-4 * d64.abs()

    def over(d):
        ratio = (d.double() - d64).abs() / bound
        return float(ratio.max()), int((ratio > 1).sum())
    (k1_worst, k1_off), (plain_worst, plain_off) = over(bwd64(got)), over(bwd64(ref))
    one32 = one.float()
    alone = over(ssl_loss_dense_bwd(sr, gt, m, *(fwd64[i].float() for i in (3, 4)), one32, one32,
                                    cfg, *(fwd64[i].float() for i in (5, 6)), stored=stored))
    out = {"d_sr_f64_k1_maps_worst_over_strict_bound": k1_worst,
           "d_sr_f64_k1_maps_off_strict": k1_off,
           "d_sr_f64_plain_maps_worst_over_strict_bound": plain_worst,
           "d_sr_f64_plain_maps_off_strict": plain_off,
           "d_sr_f32_k1_worst_over_strict_bound": over(got_d)[0],
           "d_sr_f32_k1_off_strict": over(got_d)[1],
           "d_sr_f32_plain_worst_over_strict_bound": over(ref_d)[0],
           "d_sr_f32_plain_off_strict": over(ref_d)[1],
           "d_sr_f32_backward_alone_worst_over_strict_bound": alone[0],
           "d_sr_f32_backward_alone_off_strict": alone[1]}
    if k1_worst > max(plain_worst, 1.0) or k1_off > plain_off:
        fail(f"{name} d_sr against float64: through K1's maps {k1_worst}x the strict bound at "
             f"worst, {k1_off} elements off; through the plain float32 version's "
             f"{plain_worst}x, {plain_off} off ({out})")
    return out


def phase_kernel():
    """K1 against its plain version (``hold_k1``) and a second launch bit for
    bit against the first, then its times (CUDA events, and the kernel alone
    from the profiler).  Returns the results by case: ``main_path`` and
    ``diffusion_smooth`` are the shapes the ESRGAN step and the diffusion
    mini-step give it, ``kair_<recipe>`` each KAIR recipe's, ``bench_f32``
    and ``bench_bf16`` bench.py's step in float32 and at its bf16 defaults
    (K1's stream + store mode on the stored route), ``kair_BSRGANSSL_bf16``
    BSRGAN-SSL's shape with those knobs (the batched route: K1's stream
    mode).  Each case takes the route ``dense_route`` gives its shape; in
    the bf16 store modes the walk's stack and the stream are also held
    alone (``hold_k1_stack``)."""
    import torch
    from ssl_tpu_torch.losses.ssl_loss import dense_route
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig

    shipped = SSGConfig(search=25, window=9, sigma=0.004)
    bf16 = shipped._replace(q_store_dtype="bfloat16", stream_dtype="bfloat16")
    cases = [("small", smooth_case(2, 20, 47, 0.3), SSGConfig(search=9, window=5, sigma=0.1),
              1e-5),
             ("shipped_32", smooth_case(1, 32, 2, 0.3), shipped, 1e-4),
             ("main_smooth", smooth_case(MAIN_B, MAIN_GT, 3, 0.25), shipped, 1e-4),
             ("main_path", bench_case(MAIN_B, MAIN_GT, 0, 0.25), shipped, 1e-5),
             ("diffusion_smooth", smooth_case(TRAIN_B, TRAIN_SIZE, 4, 0.25), shipped, 1e-4),
             ("realesrgan_edges", edge_case(RE_B, RE_CROP, 6), shipped, 1e-4),
             ("realesrgan_host_edges", edge_case(RE_B, RE_HOST_GT, 7), shipped, 1e-4)]
    cases += [(f"kair_{r}", kair_case(spec["batch"], spec["gt"], 8 + i), shipped, 1e-4)
              for i, (r, spec) in enumerate(KAIR.items())]
    bench_inputs = smooth_case(BENCH_B, BENCH_GT, 12, 0.25)
    cases += [("bench_f32", bench_inputs, shipped, 1e-4), ("bench_bf16", bench_inputs, bf16, 1e-4),
              ("kair_BSRGANSSL_bf16", kair_case(KAIR["BSRGANSSL"]["batch"],
                                                KAIR["BSRGANSSL"]["gt"], 8), bf16, 1e-4)]
    results = {}
    for name, arrays, cfg, map_rtol in cases:
        sr, gt, mask = (torch.from_numpy(a).cuda() for a in arrays)
        stored, cfg = dense_route(*mask.shape, cfg)
        errs, ties = hold_k1(name, sr, gt, mask, cfg, map_rtol, ssg_cuda.ssg_loss_fwd_cuda,
                             stored=stored)
        first, again = (ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg) for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"K1 {name}: a second launch differs from the first")
        del first, again
        stack_hold = (hold_k1_stack(name, sr, gt, mask, cfg, map_rtol)
                      if ssg_cuda.k1_modes(cfg)[1] else None)
        iters = 50 if sr.numel() < 1e5 else 20
        t = k1_times(sr, gt, mask, cfg, iters, stored)
        mode = k1_mode_name(cfg)
        results[name] = {"max_abs_err": max(errs.values()), "ms": t["kernel_ms"], "mode": mode,
                         "stored": stored, "stack_hold": stack_hold,
                         **{k: t[k] for k in ("device_ms", "kernels_device_ms", "call_peak_gb",
                                              "plain_ms", "bwd_ms", "bound_ms", "bound_by")},
                         **({"stream": t["stream"]} if "stream" in t else {})}
        emit({"phase": "kernel", "kernel": "ssg_loss_fwd", "case": name, "mode": mode,
              "route": "stored" if stored else "batched",
              "shape": list(sr.shape), "search": cfg.search, "window": cfg.window,
              "sigma": cfg.sigma, "max_abs_err": errs, "ties": ties, "repeat_bit_for_bit": True,
              **({"stack_hold": stack_hold} if stack_hold else {}),
              **{k: v for k, v in t.items() if k != "bound_by"},
              "launches_so_far": ssg_cuda.launches})
        del sr, gt, mask
        torch.cuda.empty_cache()
    return results


# K1's modes (ssg_cuda.k1_modes: stream_bf16, store_bf16) as the kernels line names them
K1_MODE_NAMES = {(0, 0): "float32", (1, 0): "bf16_stream", (0, 1): "bf16_store",
                 (1, 1): "bf16_stream_store"}


def k1_mode_name(cfg) -> str:
    """K1's mode for ``cfg``, as the kernels line names it."""
    from ssl_tpu_torch.ops.ssg_cuda import k1_modes
    return K1_MODE_NAMES[k1_modes(cfg)]


def k1_times(sr, gt, mask, cfg, iters: int, stored: bool = False) -> dict:
    """K1 on these inputs: the wrapper's ms (CUDA events over ``iters``
    launches), the kernels alone (profiler: with the bf16 store the walk and
    the stream, ``kernels_device_ms``, and their sum), the call's peak device
    memory above its inputs (with the bf16 store: the q stack), the plain
    forward and the plain backward (CUDA events over one call each, warm
    from the hold's runs at this shape), the bytes and operations its
    function needs and the least time they allow on the card (the
    function's, whatever the design moves: the stack is this design's own
    traffic).  With the bf16 store also the stream alone: its plain
    version's time on the same stack, and its own bound (the stack read once,
    the maps and mask read and written once: bytes)."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import (q_stream_reference, ssl_loss_dense_bwd,
                                       ssl_loss_sums_reference)
    one = torch.ones((), device="cuda")

    def call():
        return ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg)
    kernel_ms = time_ms(call, iters)
    by_kernel = kernel_device_ms(call, "ssg_loss_fwd", 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    maps = call()
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    plain_ms = time_ms(lambda: ssl_loss_sums_reference(sr, gt, mask, cfg), 1, warmup=0)
    bwd_ms = time_ms(lambda: ssl_loss_dense_bwd(sr, gt, mask, maps[3], maps[4], one, one,
                                                cfg, maps[5], maps[6], stored=stored), 1,
                     warmup=0)
    b, c, h, w = sr.shape
    nbytes = 4 * (2 * b * c * h * w + b * h * w) + 4 * (4 * b * h * w + 3)
    ops = k1_operations(b, c, h, w, cfg.search, cfg.generalization)
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)
    device_ms = sum(by_kernel.values())
    out = {"kernel_ms": kernel_ms, "device_ms": device_ms, "kernels_device_ms": by_kernel,
           "call_peak_gb": peak_gb, "plain_ms": plain_ms, "bwd_ms": bwd_ms, "bytes": nbytes,
           "operations": ops, "bound_ms": bound_ms, "fraction_of_bound": bound_ms / device_ms,
           "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S > ops / PEAK_FP32_PER_S
           else "operations"}
    if ssg_cuda.k1_modes(cfg)[1]:
        stack, inv_sr, inv_gt = ssg_cuda.q_stack_cuda(sr, gt, cfg)
        stream_bytes = stack.numel() * 2 + 4 * (5 * b * h * w)
        # per pixel-offset: decode 2, x and y 2, |x - y| and its masked sum 3,
        # the kl term 7 with two logs, a_map 2, b_map 2
        stream_ops = 18.0 * (stack.numel() // 2)
        out["stream"] = {
            "plain_ms": time_ms(lambda: q_stream_reference(stack, inv_sr, inv_gt, mask), 1),
            "bytes": stream_bytes, "operations": stream_ops,
            "bound_ms": 1e3 * max(stream_bytes / PEAK_BYTES_PER_S, stream_ops / PEAK_FP32_PER_S),
            "bound_by": "bytes" if stream_bytes / PEAK_BYTES_PER_S > stream_ops / PEAK_FP32_PER_S
            else "operations"}
        del stack
    return out


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (2^(e - 7) in the binade [2^e,
    2^(e+1)), 2^-133 among the subnormals), in float64: below 2^-126 a
    float32 exp2 on the card flushes to 0."""
    import torch
    return torch.exp2(torch.floor(torch.log2(v.double().abs().clamp_min(2.0 ** -126))) - 7)


def hold_k1_stack(name, sr, gt, mask, cfg, map_rtol) -> dict:
    """K1's two kernels of the bf16 store held alone (``cfg.q_store_dtype``
    bfloat16): the walk's stack (``ssg_cuda.q_stack_cuda``) against
    ``q_stack_reference`` on the card, every value within one bf16 ulp
    (``bf16_ulp`` of the larger of the two first values, of the larger of
    q_sr and q_gt for the difference, whose own ulp is no larger: a float32 q
    one ulp apart may round to the neighbouring bf16 value), the values that
    differ counted (a one-ulp flip each); its inverse
    maps within ``map_rtol`` (atol 1e-6 of the largest value); then the
    stream (``q_stream_cuda``) on the walk's own stack and maps against
    ``q_stream_reference`` on the same: the count exact, l1 rel 1e-4 and kl
    rel 1e-3 (sums in another order), a_map and b_map within rtol 1e-5 (atol
    1e-6 of the largest value: x and y are the same floats, only the order
    of the sums over the offsets differs); each kernel's second launch bit
    for bit.  fail() at the first disagreement; returns what it measured."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import q_stack_reference, q_stream_reference
    stack, inv_sr, inv_gt = ssg_cuda.q_stack_cuda(sr, gt, cfg)
    again = ssg_cuda.q_stack_cuda(sr, gt, cfg)
    if not all(torch.equal(x, y) for x, y in zip((stack, inv_sr, inv_gt), again)):
        fail(f"K1 walk {name}: a second launch differs from the first")
    del again
    ref, ref_sr, ref_gt = q_stack_reference(sr, gt, cfg)
    got_f, ref_f = stack.float(), ref.float()
    q_sr = ref_f[..., 0]
    q_top = torch.maximum(q_sr, torch.clamp(q_sr - ref_f[..., 1], min=0.0))
    diff = (got_f - ref_f).abs()
    over = ((diff[..., 0] > bf16_ulp(torch.maximum(q_sr.abs(), got_f[..., 0].abs())))
            | (diff[..., 1] > bf16_ulp(q_top)))
    if bool(over.any()):
        i = int(over.flatten().nonzero()[0])
        fail(f"K1 walk {name}: {int(over.sum())} stack values more than one bf16 ulp off the "
             f"plain version's; first at pixel-offset {i}: "
             f"{got_f.reshape(-1, 2)[i].tolist()} vs {ref_f.reshape(-1, 2)[i].tolist()}")
    flips = (diff > 0).sum(dim=tuple(range(diff.dim() - 1)))
    errs = {"stack_max_abs": float(diff.max())}
    for key, got, want in (("inv_sr", inv_sr, ref_sr), ("inv_gt", inv_gt, ref_gt)):
        errs[key] = check_close(f"K1 walk {name} {key}", got, want, map_rtol,
                                1e-6 * float(want.abs().max()))
    del ref, got_f, ref_f, q_sr, q_top, diff, over
    got = ssg_cuda.q_stream_cuda(stack, inv_sr, inv_gt, mask)
    again = ssg_cuda.q_stream_cuda(stack, inv_sr, inv_gt, mask)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"K1 stream {name}: a second launch differs from the first")
    want = q_stream_reference(stack, inv_sr, inv_gt, mask)
    if float(got[2]) != float(want[2]):
        fail(f"K1 stream {name}: count {float(got[2])} vs {float(want[2])}")
    errs["stream_l1"] = check_close(f"K1 stream {name} l1", got[0], want[0], 1e-4)
    errs["stream_kl"] = check_close(f"K1 stream {name} kl", got[1], want[1], 1e-3)
    for i, key in ((3, "stream_a_map"), (4, "stream_b_map")):
        errs[key] = check_close(f"K1 stream {name} {key}", got[i], want[i], 1e-5,
                                1e-6 * float(want[i].abs().max()))
    return {"max_abs_err": errs, "stack_values": stack.numel(),
            "stack_one_ulp_flips": {"q_sr": int(flips[0]), "q_sr_minus_q_gt": int(flips[1])},
            "stack_flip_share": float(flips.sum()) / stack.numel(),
            "repeat_bit_for_bit": True}


def k2_bound(products: float, elementwise: float, nbytes: float, dtype: str = "float32") -> dict:
    """K2's least times (ms): ``ops_ms`` with the matrix products as 3xTF32
    at the tensor cores' TF32 rate (float32 inputs) or once at their bf16
    rate (bf16 inputs), and the elementwise operations at the fp32 rate;
    ``bytes_ms`` for the bytes; ``fp32_ops_ms`` with everything on the CUDA
    cores (the bound of the first float32 kernels)."""
    products_s = (3 * products / PEAK_TF32_PER_S if dtype == "float32"
                  else products / PEAK_BF16_PER_S)
    return {"ops_ms": 1e3 * (products_s + elementwise / PEAK_FP32_PER_S),
            "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "fp32_ops_ms": 1e3 * (products + elementwise) / PEAK_FP32_PER_S}


def element_bytes(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def k2_times(b, h, n, m, d, dtype="float32"):
    """K2's forward: 4bhnmd for the two products, 5bhnm for scale, max, exp,
    sum and the normalisation; q, k, v read once, o written once, in
    ``dtype``."""
    return k2_bound(4 * b * h * n * m * d, 5 * b * h * n * m,
                    element_bytes(dtype) * b * h * (2 * n * d + 2 * m * d), dtype)


def k2_combine_times(b, h, n, d, split, dtype="float32"):
    """The least time of flash_attn_fwd_combine[_bf16]: it reads each part's
    output and row max and sum once (float32) and writes o (in ``dtype``)
    and lse once (bytes); per output element and part one exp-weighted FMA,
    per row and part an exp."""
    rows = b * h * n
    nbytes = 4 * split * rows * (d + 2) + rows * (element_bytes(dtype) * d + 4)
    return k2_bound(0, 2 * split * rows * d + 3 * split * rows, nbytes, dtype)


def rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def phase_k2():
    """K2's forward against its plain version at the serving path's shapes and
    at large logits, and a second launch bit for bit against the first; then
    the kernels' device times (each alone from the profiler, checked against
    ``fwd_plan``), the wrapper's, the plain version's and torch SDPA's times
    (CUDA events).  Where the plan splits the key loop, the combine's plain
    time (``combine_parts`` on parts of the same shapes).  Tolerance: rtol
    1e-4 with an atol of 1e-5 of the output's largest value (both sum in
    float32, in another order)."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import CUDA_CASES, attention_inputs, combine_parts
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import sdp_attention_reference

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in CUDA_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda")
        split, _, plan = attention_cuda.fwd_plan(b, h, n, m, d, sms)
        before = dict(attention_cuda.fwd_kernel_launches)
        got = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)
        launched = {k_: c - before[k_] for k_, c in attention_cuda.fwd_kernel_launches.items()}
        if launched != {k_: plan.get(k_, 0) for k_ in launched}:
            fail(f"K2 {name}: kernels launched {launched}, the plan {plan}")
        again = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)
        ref = sdp_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K2 {name}: a second launch differs from the first by up to "
                 f"{float((got - again).abs().max())}")
        atol = 1e-5 * float(ref.abs().max())
        err = check_close(f"K2 {name}", got, ref, 1e-4, atol)
        del again
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        def kernel():
            return attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)

        library_err = float((library().transpose(1, 2) - ref).abs().max())
        device = {k_.removesuffix("_kernel"): v_
                  for k_, v_ in kernel_device_ms(kernel, "flash_attn_fwd", 10).items()}
        if set(device) != {k_ for k_, c in plan.items() if c}:
            fail(f"K2 {name}: the profiler shows kernels {sorted(device)}, the plan {plan}")
        kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: sdp_attention_reference(q, k, v, scale), 20)
        library_ms = time_ms(library, 20)
        bound = k2_times(b, h, n, m, d)
        bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
        bound_by = "operations" if bound["ops_ms"] >= bound["bytes_ms"] else "bytes"
        combine = {}
        if split > 1:
            parts = [(torch.randn((b, n, h, d), device="cuda"),
                      torch.randn((b, h, n), device="cuda"), torch.rand((b, h, n), device="cuda"))
                     for _ in range(split)]
            combine = {"combine_plain_ms": time_ms(lambda: combine_parts(parts), 20),
                       "combine_bounds": k2_combine_times(b, h, n, d, split)}
            del parts
        results[name] = {"max_abs_err": err, "ms": kernel_ms, "device_ms": device,
                         "plain_ms": plain_ms, "library_ms": library_ms, "split": split,
                         "launches": {k_: c for k_, c in plan.items() if c}, **bound, **combine}
        emit({"phase": "kernel", "kernel": "flash_attn_fwd", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "split": split, "max_abs_err": err, "atol": atol,
              "repeat_bit_for_bit": True, "library_max_abs_err": library_err,
              "kernel_ms": kernel_ms, "kernels_device_ms": device,
              "device_ms": sum(device.values()), "plain_ms": plain_ms, "library_ms": library_ms,
              **combine, "bound_ms": bound_ms, "bound_by": bound_by,
              "fraction_of_bound": bound_ms / sum(device.values()),
              "fraction_of_fp32_bound": bound["fp32_ops_ms"] / sum(device.values())})
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    return results


def phase_k2_bf16():
    """K2's bf16 forward (flash_attn_fwd_bf16, flash_attn_fwd_d512_bf16 and
    flash_attn_fwd_combine_bf16) at the serving path's shapes and at large
    logits, the packed-qkv strides included: o against the float32 plain
    version on the same bf16 inputs upcast, within BF16_FWD_REL_L2 relative
    L2 and at most BF16_PLAIN_RATIO times the plain bf16 route's error; lse
    against ``attention_lse_reference`` on the bf16 inputs (rtol and atol
    1e-5); a second launch bit for bit.  Times as ``phase_k2``'s, the
    library yardstick SDPA on the bf16 inputs (by CUDA events, which also
    count the host's dispatch, and by device time from the profiler), the
    bounds with bf16 products and operands."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import (BF16_FWD_REL_L2, BF16_PLAIN_RATIO, CUDA_CASES,
                                       attention_inputs, combine_parts)
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import attention_lse_reference, sdp_attention_reference

    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in CUDA_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda",
                                   dtype=bf16)
        split, _, plan = attention_cuda.fwd_plan(b, h, n, m, d, sms, bf16)
        before = dict(attention_cuda.fwd_kernel_launches)
        got, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        launched = {k_: c - before[k_] for k_, c in attention_cuda.fwd_kernel_launches.items()}
        if launched != {k_: plan.get(k_, 0) for k_ in launched}:
            fail(f"K2 bf16 {name}: kernels launched {launched}, the plan {plan}")
        again, lse2 = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        ref = sdp_attention_reference(q.float(), k.float(), v.float(), scale)
        plain = sdp_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if got.dtype != bf16 or not (torch.equal(got, again) and torch.equal(lse, lse2)):
            fail(f"K2 bf16 {name}: o is {got.dtype}, or a second launch differs from the first")
        err, plain_err = rel_l2(got, ref), rel_l2(plain, ref)
        if err > BF16_FWD_REL_L2 or err > BF16_PLAIN_RATIO * plain_err:
            fail(f"K2 bf16 {name}: relative L2 {err} against float32 (bound {BF16_FWD_REL_L2}; "
                 f"the plain bf16 route's {plain_err})")
        lse_err = check_close(f"K2 bf16 {name} lse", lse, attention_lse_reference(q, k, scale),
                              1e-5, 1e-5)
        max_abs = float((got.double() - ref.double()).abs().max())
        del again, lse2
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        def kernel():
            return attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)

        library_err = rel_l2(library().transpose(1, 2), ref)
        device = {k_.removesuffix("_kernel"): v_
                  for k_, v_ in kernel_device_ms(kernel, "flash_attn_fwd", 10).items()}
        if set(device) != {k_ for k_, c in plan.items() if c}:
            fail(f"K2 bf16 {name}: the profiler shows kernels {sorted(device)}, the plan {plan}")
        kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: sdp_attention_reference(q, k, v, scale), 20)
        library_ms = time_ms(library, 20)
        library_device = device_ms(library, 10)
        bound = k2_times(b, h, n, m, d, "bfloat16")
        bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
        combine = {}
        if split > 1:
            parts = [(torch.randn((b, n, h, d), device="cuda"),
                      torch.randn((b, h, n), device="cuda"), torch.rand((b, h, n), device="cuda"))
                     for _ in range(split)]
            combine = {"combine_plain_ms": time_ms(lambda: combine_parts(parts)[0].to(bf16), 20),
                       "combine_bounds": k2_combine_times(b, h, n, d, split, "bfloat16"),
                       "combine_alone": hold_combine_bf16(name, b, h, n, d, split)}
            del parts
        results[name] = {"max_abs_err": max_abs, "rel_l2": err, "plain_rel_l2": plain_err,
                         "ms": kernel_ms, "device_ms": device, "plain_ms": plain_ms,
                         "library_ms": library_ms, "library_device_ms": library_device,
                         "split": split,
                         "launches": {k_: c for k_, c in plan.items() if c}, **bound, **combine}
        emit({"phase": "kernel", "kernel": "flash_attn_fwd_bf16", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "split": split, "rel_l2_vs_float32": err,
              "plain_bf16_rel_l2_vs_float32": plain_err, "library_rel_l2_vs_float32": library_err,
              "bounds": {"rel_l2": BF16_FWD_REL_L2, "plain_ratio": BF16_PLAIN_RATIO},
              "max_abs_err": max_abs, "lse_max_abs_err": lse_err, "repeat_bit_for_bit": True,
              "kernel_ms": kernel_ms, "kernels_device_ms": device,
              "device_ms": sum(device.values()), "plain_ms": plain_ms, "library_ms": library_ms,
              "library_device_ms": library_device, **combine, "bound_ms": bound_ms,
              "bound_by": "operations" if bound["ops_ms"] >= bound["bytes_ms"] else "bytes",
              "fraction_of_bound": bound_ms / sum(device.values())})
        del q, k, v, got, ref, plain
        torch.cuda.empty_cache()
    return results


def hold_combine_bf16(name, b, h, n, d, split) -> dict:
    """``flash_attn_fwd_combine_bf16`` alone (``attention_cuda.
    flash_attn_fwd_combine_cuda``) on seeded parts of a split bf16 forward at
    this shape: o within a bf16 rounding of the plain version's float32 o
    (``flash_attn_fwd_combine_reference``: rtol 2^-8 + 1e-5, atol 1e-6 of the
    largest value), lse within rtol and atol 1e-5, a second launch bit for
    bit; its device time (profiler) beside the plain version's and the bound,
    and the same kernel's device time at the smallest shape it takes (b = h =
    1, n = 128, d = 64, 2 parts), which is its per-launch floor on this card."""
    import torch
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import flash_attn_fwd_combine_reference

    def parts_of(b_, h_, n_, d_, split_, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.randn((split_, b_, n_, h_, d_), generator=gen, device="cuda"),
                4 * torch.randn((split_, b_, h_, n_), generator=gen, device="cuda"),
                0.5 + torch.rand((split_, b_, h_, n_), generator=gen, device="cuda"))

    o_parts, m_parts, l_parts = parts_of(b, h, n, d, split, 17)
    got, lse = attention_cuda.flash_attn_fwd_combine_cuda(o_parts, m_parts, l_parts)
    again, lse2 = attention_cuda.flash_attn_fwd_combine_cuda(o_parts, m_parts, l_parts)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(lse, lse2)):
        fail(f"flash_attn_fwd_combine_bf16 {name}: a second launch differs from the first")
    ref, ref_lse = flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts, torch.float32)
    errs = {"o": check_close(f"flash_attn_fwd_combine_bf16 {name} o", got, ref, 2.0 ** -8 + 1e-5,
                             1e-6 * float(ref.abs().max())),
            "lse": check_close(f"flash_attn_fwd_combine_bf16 {name} lse", lse, ref_lse, 1e-5,
                               1e-5)}

    def kernel():
        return attention_cuda.flash_attn_fwd_combine_cuda(o_parts, m_parts, l_parts)
    device = kernel_device_ms(kernel, "flash_attn_fwd_combine", 20)
    plain_ms = time_ms(lambda: flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts), 20)
    tiny = parts_of(1, 1, 128, 64, 2, 18)
    floor = kernel_device_ms(lambda: attention_cuda.flash_attn_fwd_combine_cuda(*tiny),
                             "flash_attn_fwd_combine", 20)
    bounds = k2_combine_times(b, h, n, d, split, "bfloat16")
    bound_ms = max(bounds["ops_ms"], bounds["bytes_ms"])
    ms = sum(device.values())
    return {"max_abs_err": errs, "repeat_bit_for_bit": True, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "fraction_of_bound": bound_ms / ms,
            "floor_ms": sum(floor.values()), "floor_shape": [1, 1, 128, 64, 2]}


def phase_k2_d512_bf16():
    """The two bf16 kernels of the VAE's single head (d = 512),
    flash_attn_fwd_d512_bf16 and flash_attn_bwd_p_ds_bf16, at vae_mid by
    batch: b = 1 (serving; the forward's key loop split in two) and b = 2
    (training; unsplit, o and lse written by the kernel itself).  Held at
    both: o against the float32 plain version on the bf16 inputs upcast
    within BF16_FWD_REL_L2 and at most BF16_PLAIN_RATIO times the plain bf16
    route's error, lse against ``attention_lse_reference`` (rtol and atol
    1e-5), both bit for bit on a second launch; the backward, fed the forward
    kernel's own o and lse, dq, dk and dv against the float32
    ``flash_attn_bwd_reference`` within BF16_BWD_REL_L2 and at most
    BF16_PLAIN_RATIO times the plain bf16 backward's error on the same o and
    lse.  Then each kernel's device time (profiler, ms a launch) beside its
    bound and SDPA's device time on the same bf16 inputs (its forward, or its
    whole backward).  Last, the backward's two products alone (dkv_mm and
    dq_mm, ``hold_mm_products``) at vae_mid b = 2 and at MM_ODD_CASE."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import (BF16_BWD_REL_L2, BF16_FWD_REL_L2, BF16_PLAIN_RATIO,
                                       CUDA_CASES, MM_ODD_CASE, TRAIN_CASES, attention_inputs)
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                             sdp_attention_reference)

    bf16 = torch.bfloat16
    for path, cases in (("serve", CUDA_CASES), ("train", TRAIN_CASES)):
        b, h, n, m, d, scale, layout, logit_range = cases["vae_mid"]
        case = f"vae_mid_{path}"
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda",
                                   dtype=bf16)
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda").to(bf16)
        o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        o2, lse2 = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        ref_o, ref_lse = sdp_attention_reference(q32, k32, v32, scale), attention_lse_reference(
            q32, k32, scale)
        plain = sdp_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if o.dtype != bf16 or not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"K2 bf16 {case}: o is {o.dtype}, or a second launch differs from the first")
        fwd_err, plain_err = rel_l2(o, ref_o), rel_l2(plain, ref_o)
        if fwd_err > BF16_FWD_REL_L2 or fwd_err > BF16_PLAIN_RATIO * plain_err:
            fail(f"K2 bf16 {case}: relative L2 {fwd_err} against float32 (bound "
                 f"{BF16_FWD_REL_L2}; the plain bf16 route's {plain_err})")
        lse_err = check_close(f"K2 bf16 {case} lse", lse, attention_lse_reference(q, k, scale),
                              1e-5, 1e-5)
        del o2, lse2, plain
        got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        ref = flash_attn_bwd_reference(q32, k32, v32, ref_o, ref_lse, do.float(), scale)
        plain = flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
        rel, plain_rel = {}, {}
        for g_name, g, r, p_ in zip(("dq", "dk", "dv"), got, ref, plain):
            rel[g_name], plain_rel[g_name] = rel_l2(g, r), rel_l2(p_, r)
            if rel[g_name] > BF16_BWD_REL_L2 or rel[g_name] > BF16_PLAIN_RATIO * plain_rel[g_name]:
                fail(f"K2 bf16 bwd {case} {g_name}: relative L2 {rel[g_name]} against float32 "
                     f"(bound {BF16_BWD_REL_L2}; the plain bf16 backward's {plain_rel[g_name]})")
        emit({"phase": "kernel", "kernel": "flash_attn_d512_bf16", "case": case,
              "b_heads_n_m_d": [b, h, n, m, d], "rel_l2_vs_float32": fwd_err,
              "plain_bf16_rel_l2_vs_float32": plain_err, "lse_max_abs_err": lse_err,
              "repeat_bit_for_bit": True, "bwd_on_own_o_lse_rel_l2_vs_float32": rel,
              "plain_bf16_bwd_rel_l2_vs_float32": plain_rel,
              "bounds": {"fwd_rel_l2": BF16_FWD_REL_L2, "bwd_rel_l2": BF16_BWD_REL_L2,
                         "plain_ratio": BF16_PLAIN_RATIO}})
        del got, ref, plain, ref_o, ref_lse, q32, k32, v32
        fwd = kernel_device_ms(lambda: attention_cuda.flash_attn_fwd_cuda(q, k, v, scale,
                                                                          return_lse=True),
                               "flash_attn_fwd", 10)
        bwd = kernel_device_ms(lambda: attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do,
                                                                          scale),
                               "flash_attn_bwd", 5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        with torch.no_grad():
            sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                                 10)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                         retain_graph=True), 5)
        f_bound = k2_times(b, h, n, m, d, "bfloat16")
        p_bound = k2_bwd_times(b, h, n, m, d, (1, 1), "bfloat16")["p_ds"]
        for kernel, ms, bound, sdpa in (
                ("flash_attn_fwd_d512_bf16", fwd["flash_attn_fwd_d512_bf16_kernel"], f_bound,
                 {"sdpa_fwd_device_ms": sdpa_fwd}),
                ("flash_attn_bwd_p_ds_bf16", bwd["flash_attn_bwd_p_ds_bf16_kernel"], p_bound,
                 {"sdpa_bwd_device_ms": sdpa_bwd})):
            bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
            emit({"phase": "kernel", "kernel": kernel, "case": case,
                  "b_heads_n_m_d": [b, h, n, m, d], "device_ms": ms, "bound_ms": bound_ms,
                  "bound_by": "operations" if bound["ops_ms"] >= bound["bytes_ms"] else "bytes",
                  "fraction_of_bound": bound_ms / ms, **sdpa,
                  "kernels_device_ms": fwd if kernel.startswith("flash_attn_fwd") else bwd})
        del q, k, v, do, o, lse, qt, kt, vt, sdpa_out, do_t
        torch.cuda.empty_cache()
    for case, shape in (("vae_mid_train", TRAIN_CASES["vae_mid"]), ("odd_key_tiles", MM_ODD_CASE)):
        hold_mm_products(case, *shape)


def mm_library_ms(p_ds, q, k, do, scale) -> dict:
    """cuBLAS's device time (profiler, ms a call) for the functions of dkv_mm
    (dV and dK: two ``torch.baddbmm`` calls) and dq_mm (dQ: one) on the
    scratch ``p_ds`` and q, k and dO in their type (``mm_library_calls``),
    with bf16's reduced-precision reduction off; TF32 is off in the kernel
    phases.  A yardstick only: the port never calls it."""
    import torch
    from torch_attention_cases import mm_library_calls
    calls = mm_library_calls(p_ds, q, k, do, scale)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return {"dkv_mm": device_ms(lambda: (calls["dv"](), calls["dk"]()), 5),
                "dq_mm": device_ms(calls["dq"], 5)}
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def hold_mm_products(case, b, h, n, m, d, scale, layout, logit_range):
    """The bf16 d = 512 backward's two products alone
    (``flash_attn_bwd_mm_cuda``) on the plain p_ds's bf16 scratch of P and dS
    (fed the float32 reference's o, in bf16, and lse): one launch of each a
    call; dq, dk and dv within MM_REL_L2 relative L2 of the float64 products
    of the same bf16 values and at most MM_LIBRARY_RATIO times the error of
    cuBLAS's bf16 products (``mm_library_calls``, float32 sums); bit for bit
    on a second launch.  Then each kernel's device time (profiler, ms a
    launch) beside its bound and cuBLAS's device time for its function
    (``mm_library_ms``)."""
    import torch
    from torch_attention_cases import (MM_LIBRARY_RATIO, MM_REL_L2, attention_inputs,
                                       mm_library_calls)
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_mm_reference,
                                             flash_attn_bwd_p_ds_reference,
                                             sdp_attention_reference)

    bf16 = torch.bfloat16
    q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda",
                               dtype=bf16)
    do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda").to(bf16)
    q32, k32 = q.float(), k.float()
    o = sdp_attention_reference(q32, k32, v.float(), scale).to(bf16)
    p_ds = flash_attn_bwd_p_ds_reference(q, k, v, o, attention_lse_reference(q32, k32, scale), do,
                                         scale)
    del q32, k32, o, v
    before = dict(attention_cuda.bwd_kernel_launches)
    got = attention_cuda.flash_attn_bwd_mm_cuda(p_ds, q, k, do, scale)
    launched = {k_: c - before[k_] for k_, c in attention_cuda.bwd_kernel_launches.items()
                if c != before[k_]}
    if launched != dict.fromkeys(attention_cuda.MM_KERNELS_BF16, 1):
        fail(f"K2 bf16 products {case}: one call launched {launched}")
    again = attention_cuda.flash_attn_bwd_mm_cuda(p_ds, q, k, do, scale)
    exact = flash_attn_bwd_mm_reference(p_ds.double(), q.double(), k.double(), do.double(), scale)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        library = {name: call() for name, call in mm_library_calls(p_ds, q, k, do, scale).items()}
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.synchronize()
    rel, lib_rel = {}, {}
    for name, g, g2, e in zip(("dq", "dk", "dv"), got, again, exact):
        if g.dtype != bf16 or not torch.equal(g, g2):
            fail(f"K2 bf16 products {case} {name}: {g.dtype}, or a second launch differs")
        rel[name], lib_rel[name] = rel_l2(g, e), rel_l2(library[name], e)
        if rel[name] > MM_REL_L2 or rel[name] > MM_LIBRARY_RATIO * lib_rel[name]:
            fail(f"K2 bf16 products {case} {name}: relative L2 {rel[name]} against float64 "
                 f"(bound {MM_REL_L2}; cuBLAS's {lib_rel[name]}, ratio {MM_LIBRARY_RATIO})")
    del got, again, exact, library
    times = kernel_device_ms(lambda: attention_cuda.flash_attn_bwd_mm_cuda(p_ds, q, k, do, scale),
                             "flash_attn_bwd", 10)
    library_ms = mm_library_ms(p_ds, q, k, do, scale)
    bounds = k2_bwd_times(b, h, n, m, d, (1, 1), "bfloat16")
    for kernel, key in zip(attention_cuda.MM_KERNELS_BF16, ("dkv_mm", "dq_mm")):
        bound = bounds[key]
        bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
        ms = times[f"{kernel}_kernel"]
        emit({"phase": "kernel", "kernel": kernel, "case": case, "b_heads_n_m_d": [b, h, n, m, d],
              "device_ms": ms, "bound_ms": bound_ms,
              "bound_by": "operations" if bound["ops_ms"] >= bound["bytes_ms"] else "bytes",
              "fraction_of_bound": bound_ms / ms, "library_ms": library_ms[key],
              "library_is": "cuBLAS, one torch.baddbmm(beta=0, alpha=scale) a product, device "
                            "time (profiler)",
              "rel_l2_vs_float64": rel, "library_rel_l2_vs_float64": lib_rel,
              "repeat_bit_for_bit": True,
              "bounds": {"rel_l2": MM_REL_L2, "library_ratio": MM_LIBRARY_RATIO}})
    del q, k, do, p_ds
    torch.cuda.empty_cache()


def mm_products_times(q, k, v, o, lse, do, scale, iters: int) -> dict:
    """At d = 512, the function of dkv_mm and dq_mm alone on the P/dS
    scratch that the plain p_ds forms from these inputs: cuBLAS's device time
    by kernel (``mm_library_ms``) and the plain dkv_mm and dq_mm together
    (``flash_attn_bwd_mm_reference``, CUDA events)."""
    from ssl_tpu_torch.ops.attention import (flash_attn_bwd_mm_reference,
                                             flash_attn_bwd_p_ds_reference)
    p_ds = flash_attn_bwd_p_ds_reference(q, k, v, o, lse, do, scale)
    return {"mm_library_ms": mm_library_ms(p_ds, q, k, do, scale),
            "mm_plain_ms": time_ms(lambda: flash_attn_bwd_mm_reference(p_ds, q, k, do, scale),
                                   iters)}


def k2_bwd_times(b, h, n, m, d, splits=(1, 1), dtype="float32"):
    """The least times of K2's backward kernels (``k2_bound`` each).  Per
    kernel: the fused dkv needs q kᵀ, dO vᵀ, Pᵀ dO and dSᵀ q (8bhnmd) and
    5bhnm for P and dS; the fused dq q kᵀ, dO vᵀ and dS k (6bhnmd) and the
    same 5bhnm; at d = 512 p_ds needs the two logit products (4bhnmd) and
    5bhnm and writes P and dS, dkv_mm Pᵀ dO and dSᵀ q (4bhnmd) and dq_mm dS k
    (2bhnmd), reading P and dS; sum adds the split parts (``splits`` =
    dkv's, dq's).  "bwd" is the function: 10bhnmd + 8bhnm, q, k, v, dO, lse
    and di read once and dq, dk, dv written once.  q, k, v, dO, the
    gradients and P and dS are ``dtype``; lse, di and split parts float32."""
    e = element_bytes(dtype)
    nm, nd, md = b * h * n * m, b * h * n * d, b * h * m * d
    inputs = e * (2 * nd + 2 * md) + 4 * 2 * b * h * n
    parts = 2 * md * splits[0] * (splits[0] > 1) + nd * splits[1] * (splits[1] > 1)
    outs = 2 * md * (splits[0] > 1) + nd * (splits[1] > 1)
    work = {"dkv": (8 * nm * d, 5 * nm, inputs + e * 2 * md),
            "dq": (6 * nm * d, 5 * nm, inputs + e * nd),
            "p_ds": (4 * nm * d, 5 * nm, inputs + e * 2 * nm),
            "dkv_mm": (4 * nm * d, 0, e * (2 * nm + 2 * nd + 2 * md)),
            "dq_mm": (2 * nm * d, 0, e * (nm + md + nd)),
            "sum": (0, parts - outs, 4 * parts + e * outs),
            "bwd": (10 * nm * d, 8 * nm, inputs + e * (nd + 2 * md))}
    return {k: k2_bound(*w, dtype) for k, w in work.items()}


def kernel_launch_counts() -> dict:
    """The port's launch counters (each wrapper adds one where it launches),
    by the kernels' names in a profiler trace."""
    from ssl_tpu_torch.ops import attention_cuda, ssg_cuda
    return {"ssg_loss_fwd_kernel": ssg_cuda.launches,
            # absent from a checkout before the stream kernel (scripts' --root)
            "ssg_loss_fwd_stream_kernel": getattr(ssg_cuda, "stream_launches", 0),
            **{f"{k}_kernel": n for k, n in attention_cuda.fwd_kernel_launches.items()},
            **{f"{k}_kernel": n for k, n in attention_cuda.bwd_kernel_launches.items()}}


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn`` (ms): every CUDA kernel the
    profiler records over ``iters`` calls, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / iters


def kernel_device_ms(fn, prefix: str, iters: int = 5) -> dict:
    """Device time (ms per call of ``fn``) of each kernel whose name contains
    ``prefix``, by its short name, from torch.profiler over ``iters`` calls:
    the mean time of the launches the trace recorded, times the launches a
    call made (``kernel_launch_counts``).  Late in a whole run the profiler
    has handed back traces that miss some launches (one of five of K1 at the
    KAIR shapes, one to five of ten of K2's forward kernels), or every CUDA
    event of a run; a trace that misses every launch of a kernel is taken
    again, up to three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        before = kernel_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in kernel_launch_counts().items()
                    if prefix in k and n > before[k]}
        total, recorded = {}, {}
        for e in prof.key_averages():
            short = re.search(re.escape(prefix) + r"\w*", e.key)
            if e.device_type.name == "CUDA" and short:
                total[short[0]] = total.get(short[0], 0.0) + e.self_device_time_total / 1e3
                recorded[short[0]] = recorded.get(short[0], 0) + e.count
        if launched and set(recorded) == set(launched) and \
                all(total[k] > 0 and 0 < recorded[k] <= n for k, n in launched.items()):
            if recorded != launched:
                print(f"chip_smoke: the profiler's trace of {prefix} holds {recorded} of the "
                      f"launches {launched}", file=sys.stderr, flush=True)
            return {k: total[k] / recorded[k] * n / iters for k, n in launched.items()}
        print(f"chip_smoke: the profiler's trace of {prefix} holds {recorded} of the launches "
              f"{launched}; taking it again", file=sys.stderr, flush=True)
    fail(f"the profiler shows no device time for {prefix}: {total}, {recorded} of the "
         f"launches {launched}")


def phase_k2_bwd():
    """K2's backward (and the forward's lse) against the plain versions at
    the training path's shapes and at large logits, and a second launch
    bit for bit against the first; then times.  The plain and SDPA times are
    of the whole backward (dq, dk and dv); where the plan splits a loop, the
    plain (an in-order loop) and library (torch.sum) times of one sum of
    split parts."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import TRAIN_CASES, attention_inputs
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                             sdp_attention_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in TRAIN_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda")
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
        o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        ref_o, ref_lse = sdp_attention_reference(q, k, v, scale), attention_lse_reference(q, k, scale)
        errs = {"o": check_close(f"K2 bwd {name} o", o, ref_o, 1e-4,
                                 1e-5 * float(ref_o.abs().max())),
                "lse": check_close(f"K2 bwd {name} lse", lse, ref_lse, 1e-5, 1e-5)}
        got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        again = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        for g_name, g, g2 in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(g, g2):
                fail(f"K2 bwd {name} {g_name}: a second launch differs from the first by up to "
                     f"{float((g - g2).abs().max())}")
        del again
        refs = {"reference": flash_attn_bwd_reference(q, k, v, ref_o, ref_lse, do, scale)}
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        sdp_attention_reference(*leaves, scale).backward(do)
        refs["autograd"] = [t.grad for t in leaves]
        rel = {}
        for against, ref in refs.items():
            for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
                rel[f"{g_name}_vs_{against}"] = float((g - r).norm() / r.norm())
                errs[f"{g_name}_vs_{against}"] = check_close(
                    f"K2 bwd {name} {g_name} vs {against}", g, r, BWD_RTOL,
                    BWD_ATOL * float(r.abs().max()))
        if max(rel.values()) > BWD_REL_L2:
            fail(f"K2 bwd {name}: relative L2 {rel} above {BWD_REL_L2}")
        del refs, leaves, got

        def kernel():
            attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)

        iters = 5 if d == 512 or n == 4096 else 20
        split = kernel_device_ms(kernel, "flash_attn_bwd", iters)
        dkv_split, dq_split, _, launches = attention_cuda.bwd_plan(b, h, n, m, d, sms)
        if set(split) != {f"{k_}_kernel" for k_ in launches if launches[k_]}:
            fail(f"K2 bwd {name}: the profiler shows kernels {sorted(split)}, the plan {launches}")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        kernel_ms = time_ms(kernel, iters)
        plain_ms = time_ms(lambda: flash_attn_bwd_reference(q, k, v, o, lse, do, scale), iters)
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                         retain_graph=True), iters)
        bounds = k2_bwd_times(b, h, n, m, d, (dkv_split, dq_split))
        sums = {}
        if dkv_split > 1 or dq_split > 1:      # one output's parts, as the sum kernel adds them
            nparts, size = ((dkv_split, b * m * h * d) if dkv_split > 1
                            else (dq_split, b * n * h * d))
            parts = torch.randn((nparts, size), device="cuda")

            def ordered():
                out = parts[0].clone()
                for part in parts[1:]:
                    out += part
                return out

            sums = {"sum_plain_ms": time_ms(ordered, iters),
                    "sum_library_ms": time_ms(lambda: parts.sum(0), iters)}
            del parts
        sums.update(mm_products_times(q, k, v, o, lse, do, scale, iters) if d == 512 else {})
        results[name] = {"max_abs_err": max(errs.values()), "ms": kernel_ms,
                         "kernel_ms": {k_.removesuffix("_kernel"): v_ for k_, v_ in split.items()},
                         "launches": {k_: c for k_, c in launches.items() if c},
                         "plain_ms": plain_ms, "library_ms": library_ms, "bounds": bounds, **sums}
        emit({"phase": "kernel", "kernel": "flash_attn_bwd", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "splits": [dkv_split, dq_split],
              "max_abs_err": errs, "rel_l2": rel, "repeat_bit_for_bit": True,
              "kernel_ms": kernel_ms, "kernels_device_ms": split, "plain_ms": plain_ms,
              "library_ms": library_ms, **sums,
              "bound_ms": {k_: max(v_["ops_ms"], v_["bytes_ms"]) for k_, v_ in bounds.items()},
              "fraction_of_bound": bounds["bwd"]["ops_ms"] / kernel_ms,
              "fraction_of_fp32_bound": bounds["bwd"]["fp32_ops_ms"] / kernel_ms})
        del q, k, v, o, lse, do, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    return results


def phase_k2_bwd_bf16():
    """K2's bf16 backward at the training path's shapes and at large logits,
    fed the float32 reference's o (rounded to bf16) and lse: dq, dk and dv
    against the float32 ``flash_attn_bwd_reference`` on the same inputs
    upcast within BF16_BWD_REL_L2 relative L2 and at most BF16_PLAIN_RATIO
    times the error of ``flash_attn_bwd_reference`` on the bf16 inputs (the
    kernels' rounding points); a second launch bit for bit.  Times as
    ``phase_k2_bwd``'s, SDPA's backward on the bf16 inputs as the yardstick,
    the bounds with bf16 products and operands."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import (BF16_BWD_REL_L2, BF16_PLAIN_RATIO, TRAIN_CASES,
                                       attention_inputs)
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                             sdp_attention_reference)

    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in TRAIN_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda",
                                   dtype=bf16)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda").to(bf16)
        ref_o, lse = sdp_attention_reference(q32, k32, v32, scale), attention_lse_reference(
            q32, k32, scale)
        o = ref_o.to(bf16)
        got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        again = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        for g_name, g, g2 in zip(("dq", "dk", "dv"), got, again):
            if g.dtype != bf16 or not torch.equal(g, g2):
                fail(f"K2 bf16 bwd {name} {g_name}: {g.dtype}, or a second launch differs")
        del again
        ref = flash_attn_bwd_reference(q32, k32, v32, ref_o, lse, do.float(), scale)
        plain = flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
        rel, plain_rel = {}, {}
        for g_name, g, r, p_ in zip(("dq", "dk", "dv"), got, ref, plain):
            rel[g_name], plain_rel[g_name] = rel_l2(g, r), rel_l2(p_, r)
            if rel[g_name] > BF16_BWD_REL_L2 or rel[g_name] > BF16_PLAIN_RATIO * plain_rel[g_name]:
                fail(f"K2 bf16 bwd {name} {g_name}: relative L2 {rel[g_name]} against float32 "
                     f"(bound {BF16_BWD_REL_L2}; the plain bf16 backward's {plain_rel[g_name]})")
        max_abs = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        del ref, plain, got

        def kernel():
            attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)

        iters = 5 if d == 512 or n == 4096 else 20
        split = kernel_device_ms(kernel, "flash_attn_bwd", iters)
        dkv_split, dq_split, _, launches = attention_cuda.bwd_plan(b, h, n, m, d, sms, bf16)
        if set(split) != {f"{k_}_kernel" for k_ in launches if launches[k_]}:
            fail(f"K2 bf16 bwd {name}: the profiler shows kernels {sorted(split)}, the plan "
                 f"{launches}")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        kernel_ms = time_ms(kernel, iters)
        plain_ms = time_ms(lambda: flash_attn_bwd_reference(q, k, v, o, lse, do, scale), iters)
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                         retain_graph=True), iters)
        bounds = k2_bwd_times(b, h, n, m, d, (dkv_split, dq_split), "bfloat16")
        sums = {}
        if dkv_split > 1 or dq_split > 1:      # one output's parts, as the sum kernel adds them
            nparts, size = ((dkv_split, b * m * h * d) if dkv_split > 1
                            else (dq_split, b * n * h * d))
            parts = torch.randn((nparts, size), device="cuda")

            def ordered():
                out = parts[0].clone()
                for part in parts[1:]:
                    out += part
                return out.to(bf16)

            sums = {"sum_plain_ms": time_ms(ordered, iters),
                    "sum_library_ms": time_ms(lambda: parts.sum(0).to(bf16), iters)}
            del parts
        sums.update(mm_products_times(q, k, v, o, lse, do, scale, iters) if d == 512 else {})
        results[name] = {"max_abs_err": max_abs, "rel_l2": rel, "ms": kernel_ms,
                         "kernel_ms": {k_.removesuffix("_kernel"): v_ for k_, v_ in split.items()},
                         "launches": {k_: c for k_, c in launches.items() if c},
                         "plain_ms": plain_ms, "library_ms": library_ms, "bounds": bounds, **sums}
        bound_ms = {k_: max(v_["ops_ms"], v_["bytes_ms"]) for k_, v_ in bounds.items()}
        emit({"phase": "kernel", "kernel": "flash_attn_bwd_bf16", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "splits": [dkv_split, dq_split],
              "rel_l2_vs_float32": rel, "plain_bf16_rel_l2_vs_float32": plain_rel,
              "bounds": {"rel_l2": BF16_BWD_REL_L2, "plain_ratio": BF16_PLAIN_RATIO},
              "max_abs_err": max_abs, "repeat_bit_for_bit": True, "kernel_ms": kernel_ms,
              "kernels_device_ms": split, "plain_ms": plain_ms, "library_ms": library_ms, **sums,
              "bound_ms": bound_ms, "fraction_of_bound": bounds["bwd"]["ops_ms"] / kernel_ms,
              # each kernel's bound over its device time (dkv and dq; at d = 512 p_ds,
              # dkv_mm and dq_mm; sum where the plan splits)
              "fraction_of_bound_by_kernel": {
                  k_: bound_ms[re.sub(r"^flash_attn_bwd_|_bf16_kernel$", "", k_)] / t_
                  for k_, t_ in split.items()}})
        del q, k, v, q32, k32, v32, o, lse, do, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    return results


def ssl_base_cfg() -> dict:
    """options/diffusion/ssl_base.yml's model, sslopt and train blocks as a dict
    (the card's machine has no yaml), with model.use_flash_attention on, as
    scripts/bench_diffusion_ssl.py sets it with BENCH_FLASH_ATTN=1."""
    return {
        "model": {"timesteps": 1000, "beta_schedule": "linear", "linear_start": 0.00085,
                  "linear_end": 0.012, "parameterization": "eps", "scale_factor": 0.18215,
                  "pixel_weight": 0.1, "context_dim": 1024, "use_flash_attention": True,
                  "unet": {"model_channels": 256, "num_res_blocks": 2, "channel_mult": [1, 2, 4],
                           "attention_resolutions": [4, 2, 1], "num_heads": 8},
                  "first_stage": {"embed_dim": 4, "ch": 128, "ch_mult": [1, 2, 4, 4],
                                  "num_res_blocks": 2}},
        "sslopt": {"l1_weight": 0.5, "kl_weight": 0.5, "mask_stride": 3,
                   "kernel_size_search": 25, "kernel_size_window": 9, "sigma": 0.004,
                   "generalization": True, "impl": "dense"},
        "train": {"lr": 5.0e-5, "accumulate_grad_batches": 12, "max_steps": 800000,
                  "log_every": 100, "save_every": 1000},
    }


def lq_image(size: int, up: int, seed: int):
    """A smooth synthetic LQ image (1, 3, size, size) in [0, 1], bicubically
    upsampled on the card to (1, 3, up, up) as the CLI does with cv2."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = rng.rand(3, 2) * 6.0
    img = np.stack([0.5 + 0.35 * np.sin(5 * yy + 3 * xx + a) * np.cos(4 * xx - 2 * yy + b)
                    for a, b in phase])[None].astype(np.float32)
    lq = torch.from_numpy(img).cuda()
    return F.interpolate(lq, size=(up, up), mode="bicubic", align_corners=False).clamp(0, 1)


def flash_modules(state):
    """Every module with a flash switch: the VAE's, and the UNet's and the
    struct-cond encoder's in both the weights and their EMA."""
    nets = [state.frozen["vae"]] + [p[k] for p in (state.params, state.ema_params)
                                     for k in ("unet", "structcond")]
    return [m for net in nets for m in net.modules() if hasattr(m, "use_flash_attention")]


def redraw_zero_init(state) -> None:
    """Draw every layer the init leaves at 0 from a seeded normal scaled by
    fan-in, the same draws for the weights and their EMA."""
    import torch
    with torch.no_grad():
        for i, name in enumerate(("unet", "structcond")):
            for params in (state.params, state.ema_params):
                gen = torch.Generator(device="cuda").manual_seed(100 + i)
                for m in params[name].modules():
                    if getattr(m, "zero_init", False):
                        m.weight.normal_(generator=gen).mul_(m.weight[0].numel() ** -0.5)


def phase_diffusion():
    """The full-width model, its zero-initialised layers drawn from a seeded
    normal scaled by fan-in (the same draws for the weights and their EMA),
    and the UNet's output std as evidence that every branch reaches it."""
    import torch
    from ssl_tpu_torch.diffusion.main import build_from_config

    t0 = time.perf_counter()
    model = build_from_config(ssl_base_cfg())
    state = model.init_state(seed=0)
    redraw_zero_init(state)
    with torch.no_grad():
        p = model.infer_params(state)
        gen = torch.Generator(device="cuda").manual_seed(5)
        z = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
        eps = model.apply_model(p, z, torch.full((1,), 500, device="cuda"),
                                p["null_context"][None], z)
    torch.cuda.synchronize()
    std = float(eps.std())
    if not (std > 0 and bool(torch.isfinite(eps).all())):
        fail(f"UNet output std {std}: the output is degenerate")
    emit({"phase": "diffusion", "config": "options/diffusion/ssl_base.yml",
          "use_flash_attention": True, "setup_s": time.perf_counter() - t0,
          "params_m": {k: sum(x.numel() for x in net.parameters()) / 1e6 for k, net in
                       (("unet", p["unet"]), ("structcond", p["structcond"]),
                        ("vae", state.frozen["vae"]))},
          "unet_out_std": std})
    return model, state


def phase_e2e(model, state):
    """One 256^2 request through the K2 route and the plain route."""
    import torch
    from ssl_tpu_torch.diffusion.test_cli import restore
    from ssl_tpu_torch.ops import attention_cuda

    lq_up = lq_image(E2E_LQ, 4 * E2E_LQ, seed=1)
    outs, launches = {}, {}
    for route, flash in (("k2", True), ("plain", False)):
        for m in flash_modules(state):
            m.use_flash_attention = flash
        before = attention_cuda.launches
        gen = torch.Generator(device="cuda").manual_seed(7)
        outs[route] = restore(model, state, lq_up, gen, "ddpm", E2E_STEPS, colorfix="nofix")
        torch.cuda.synchronize()
        launches[route] = attention_cuda.launches - before
    for m in flash_modules(state):
        m.use_flash_attention = True
    if launches != {"k2": E2E_K2_LAUNCHES, "plain": 0}:
        fail(f"e2e: K2 launches {launches}, expected {E2E_K2_LAUNCHES} on the K2 route, 0 plain")
    a, b = outs["k2"].double(), outs["plain"].double()
    if not bool(torch.isfinite(a).all()):
        fail("e2e: the K2 route's image is not finite")
    rel_l2 = float((a - b).norm() / b.norm())
    emit({"phase": "e2e", "size": 4 * E2E_LQ, "steps": E2E_STEPS, "k2_launches": launches,
          "rel_l2": rel_l2, "bound": E2E_REL_L2, "max_abs": float((a - b).abs().max()),
          "image_std": float(b.std())})
    if not rel_l2 <= E2E_REL_L2:
        fail(f"e2e: decoded images of the K2 and plain routes differ by {rel_l2} relative L2 "
             f"(bound {E2E_REL_L2})")


def phase_serve(model, state):
    """Two 512^2 requests through the CLI's ``restore``; K2 counted around them."""
    import torch
    from ssl_tpu_torch.diffusion.test_cli import restore
    from ssl_tpu_torch.ops import attention_cuda

    images = [lq_image(SERVE_LQ, SERVE_SIZE, seed=10 + i) for i in range(SERVE_REQUESTS)]
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    requests = []
    reset_k2_counts()
    for lq_up in images:
        timings = {}
        t0 = time.perf_counter()
        img = restore(model, state, lq_up, gen, "ddpm", SERVE_STEPS, timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        ok = (tuple(img.shape) == (1, 3, SERVE_SIZE, SERVE_SIZE)
              and bool(torch.isfinite(img).all()) and 0 <= float(img.min()) <= float(img.max()) <= 1)
        if not ok:
            fail(f"serve: output {tuple(img.shape)} is wrong, not finite or outside [0, 1]")
        requests.append({"ms": 1e3 * total, "ms_per_step": 1e3 * timings["sample"] / SERVE_STEPS,
                         "vae_encode_ms": 1e3 * timings["encode"],
                         "vae_decode_ms": 1e3 * timings["decode"],
                         "colorfix_ms": 1e3 * timings["colorfix"],
                         "finite": True, "shape": list(img.shape), "std": float(img.std())})
    launches = attention_cuda.launches
    fwd_kernels = dict(attention_cuda.fwd_kernel_launches)
    expected = SERVE_REQUESTS * (K2_PER_REQUEST + SERVE_STEPS * K2_PER_STEP)
    emit({"phase": "serve", "config": "options/diffusion/ssl_base.yml", "size": SERVE_SIZE,
          "sampler": "ddpm", "steps": SERVE_STEPS, "requests": requests,
          "k2_launches": launches, "k2_expected": expected, "k2_fwd_kernel_launches": fwd_kernels,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    if launches != expected:
        fail(f"serve: K2 launched {launches} times, expected {expected}")
    idle = [k_ for k_, c in fwd_kernels.items() if c == 0 and not k_.endswith("_bf16")]
    if idle:
        fail(f"serve: K2 forward kernels {idle} were never launched: {fwd_kernels}")
    return launches, fwd_kernels


def train_batch(size: int, seed: int) -> dict:
    """A smooth synthetic GT (2, 3, size, size) in [0, 1] made on the card,
    its LQ (4x area-downsampled, bicubically upsampled back, as the pipeline
    hands it over), and an edge mask of density 0.25 (bench.py's)."""
    import torch
    import torch.nn.functional as F
    gt = torch.cat([lq_image(size, size, seed=seed + i) for i in range(TRAIN_B)])
    lq = F.interpolate(F.avg_pool2d(gt, 4), size=(size, size), mode="bicubic",
                       align_corners=False).clamp(0, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = (torch.rand((TRAIN_B, 1, size, size), generator=gen, device="cuda") < 0.25).float()
    return {"gt": gt, "lq": lq, "gt_mask": mask}


def reset_training(state) -> None:
    """Back to no accumulated gradient, mini-step 0 (the weights are as they
    were: no update has been applied)."""
    state.opt.zero_grad(set_to_none=True)
    state.step = state.mini_step = 0


def phase_train_e2e(model, state):
    """One mini-step at 256^2 through the K2 route and the plain route, from
    the same weights and handed-in draws; the first of 12 mini-steps leaves
    the summed gradients in .grad and the weights untouched."""
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import latent_shape, trainable
    from ssl_tpu_torch.ops import attention_cuda

    batch = train_batch(TRAIN_E2E_SIZE, seed=20)
    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = latent_shape(state.frozen["vae"], TRAIN_B, TRAIN_E2E_SIZE, TRAIN_E2E_SIZE)
    draws = {"enc_noise": torch.randn((2 * TRAIN_B, *shape[1:]), generator=gen, device="cuda"),
             "t": torch.tensor([1, 3], device="cuda") * (model.sched.num_timesteps // 4),
             "noise": torch.randn(shape, generator=gen, device="cuda")}
    logs, grads, launches = {}, {}, {}
    for route, flash in (("k2", True), ("plain", False)):
        for m in flash_modules(state):
            m.use_flash_attention = flash
        reset_training(state)
        attention_cuda.launches = attention_cuda.bwd_launches = 0
        _, out = model.train_step(state, batch, draws)
        torch.cuda.synchronize()
        launches[route] = {"fwd": attention_cuda.launches, "bwd": attention_cuda.bwd_launches}
        logs[route] = {k: float(v) for k, v in out.items()}
        grads[route] = [p.grad.detach().clone() for p in trainable(state.params)]
    for m in flash_modules(state):
        m.use_flash_attention = True
    reset_training(state)
    if launches != {"k2": TRAIN_E2E_K2, "plain": {"fwd": 0, "bwd": 0}}:
        fail(f"train_e2e: K2 launches {launches}, expected {TRAIN_E2E_K2} on the K2 route")
    names = [f"{net}.{n}" for net in ("unet", "structcond")
             for n, _ in state.params[net].named_parameters()] + ["null_context"]
    norms = [float(g.norm()) for g in grads["plain"]]
    # a gradient below 1e-6 of the largest one is rounding noise (the
    # function does not depend on that parameter), so its relative error is
    # not a measure of the kernels; such parameters are counted, not held
    resolved = [n > 1e-6 * max(norms) for n in norms]
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(grads["k2"], grads["plain"])]
    held = [r for r, ok in zip(rel, resolved) if ok]
    total = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(*grads.values())))
                  / torch.sqrt(sum((b ** 2).sum() for b in grads["plain"])))
    finite = all(bool(torch.isfinite(g).all()) for g in grads["k2"])
    log_err = {k: abs(logs["k2"][k] - v) / abs(v) for k, v in logs["plain"].items()}
    worst = sorted(range(len(rel)), key=lambda i: -rel[i])[:5]
    emit({"phase": "train_e2e", "size": TRAIN_E2E_SIZE, "batch": TRAIN_B, "k2_launches": launches,
          "logs": logs, "log_rel_err": log_err, "grad_rel_l2_held_max": max(held),
          "grad_rel_l2_all": total, "n_params": len(rel), "n_unresolved": len(rel) - len(held),
          "grad_rel_l2_worst": [[names[i], rel[i], norms[i] / max(norms)] for i in worst],
          "grad_bound": TRAIN_GRAD_REL_L2, "log_bound": TRAIN_LOG_RTOL,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    if not finite or not all(map(lambda x: x == x, logs["k2"].values())):
        fail("train_e2e: the K2 route's gradients or logs are not finite")
    if max(log_err.values()) > TRAIN_LOG_RTOL:
        fail(f"train_e2e: logs differ by {log_err} (rtol {TRAIN_LOG_RTOL})")
    if max(held) > TRAIN_GRAD_REL_L2 or total > TRAIN_GRAD_REL_L2:
        fail(f"train_e2e: a parameter's gradient differs by {max(held)} relative L2, all "
             f"together by {total} (bound {TRAIN_GRAD_REL_L2})")


def phase_diffusion_train(model, state):
    """One full accumulation cycle at 512^2 through train_step, of
    TRAIN_MINI_STEPS mini-steps (the model's shipped accumulate set to that
    for the phase); returns the K1, K2 forward and K2 backward launch counts
    of the run."""
    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
    from ssl_tpu_torch.ops import attention_cuda, ssg_cuda

    shipped, model.accumulate = model.accumulate, TRAIN_MINI_STEPS

    batches = [train_batch(TRAIN_SIZE, seed=30 + 2 * i) for i in range(TRAIN_MINI_STEPS)]
    start = [p.detach().clone() for p in trainable(state.params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssg_cuda.launches = 0
    reset_k2_counts()
    ms, logs, k2_bwd_ms = [], [], None
    for i, batch in enumerate(batches):
        if i == TRAIN_MINI_STEPS - 1:
            ema_before = [e.clone() for e in trainable(state.ema_params)]
        t0 = time.perf_counter()
        if i == 1:            # a warm mini-step under the profiler (kept out of the warm times)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, out = model.train_step(state, batch)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            k2_bwd_ms = {}
            for e in events:
                short = re.search(r"flash_attn_(fwd|bwd)\w*", e.key)
                if short:
                    k2_bwd_ms[short[0]] = (k2_bwd_ms.get(short[0], 0.0)
                                           + e.self_device_time_total / 1e3)
            for way in ("fwd", "bwd"):
                k2_bwd_ms[f"flash_attn_{way}_all"] = sum(
                    v for k_, v in k2_bwd_ms.items() if k_.startswith(f"flash_attn_{way}_"))
            k2_bwd_ms["device_busy"] = sum(e.self_device_time_total for e in events) / 1e3
        else:
            _, out = model.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        values = {k: float(v) for k, v in out.items()}
        logs.append(values)
        if not all(np.isfinite(v) for v in values.values()):
            fail(f"diffusion_train: mini-step {i + 1} logged {values}")
        same = all(torch.equal(a, p) for a, p in zip(start, trainable(state.params)))
        if same != (i < TRAIN_MINI_STEPS - 1):
            fail(f"diffusion_train: after mini-step {i + 1} the weights "
                 f"{'did not move' if same else 'moved'}")
    launches = {"k1": ssg_cuda.launches, "k2_fwd": attention_cuda.launches,
                "k2_bwd": attention_cuda.bwd_launches}
    bwd_kernels = dict(attention_cuda.bwd_kernel_launches)
    fwd_kernels = dict(attention_cuda.fwd_kernel_launches)
    if any(torch.equal(a, e) for a, e in zip(ema_before, trainable(state.ema_params))):
        fail("diffusion_train: an EMA tensor did not move at the applying mini-step")
    model.accumulate = shipped
    n = TRAIN_MINI_STEPS
    expected = {"k1": n, "k2_fwd": n * TRAIN_K2_FWD, "k2_bwd": n * TRAIN_K2_BWD}
    emit({"phase": "diffusion_train", "config": "options/diffusion/ssl_base.yml",
          "size": TRAIN_SIZE, "batch": TRAIN_B, "mini_steps": n,
          "accumulate": n, "reduced": {"accumulate_grad_batches": [shipped, n]},
          "lr": model.lr, "ms_first": ms[0],
          "ms_profiled": ms[1], "ms_warm_mean": sum(ms[2:-1]) / len(ms[2:-1]),
          "ms_warm": ms[2:-1], "ms_applying": ms[-1], "logs_first": logs[0], "logs_last": logs[-1],
          "launches": launches, "expected": expected, "k2_bwd_kernel_launches": bwd_kernels,
          "k2_fwd_kernel_launches": fwd_kernels,
          "device_ms_profiled_mini_step": k2_bwd_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    if launches != expected:
        fail(f"diffusion_train: launches {launches}, expected {expected}")
    idle = [k_ for k_, c in {**bwd_kernels, **fwd_kernels}.items()
            if c == 0 and not k_.endswith("_bf16")]
    if idle:
        fail(f"diffusion_train: K2 kernels {idle} were never launched: "
             f"{bwd_kernels}, {fwd_kernels}")
    return dict(launches, **bwd_kernels, **fwd_kernels)


def cfw_reference_cfg(vae_ckpt: str, dump: str) -> dict:
    """The reference's configs/autoencoder/autoencoder_kl_64x64x4_resi.yaml
    (OmegaConf schema) at its widths (CFW_WIDTHS), with ``ckpt_path`` on the
    phase's reference-layout VAE and the data on the phase's dump."""
    return {
        "model": {"base_learning_rate": 5.0e-5,
                  "target": "ldm.models.autoencoder.AutoencoderKLResi",
                  "params": {"embed_dim": 4, "monitor": "val/rec_loss", "ckpt_path": vae_ckpt,
                             "fusion_w": 1.0, "freeze_dec": True, "synthesis_data": False,
                             "lossconfig": {"target": "ldm.modules.losses.LPIPSWithDiscriminator",
                                            "params": {"disc_start": 501, "kl_weight": 0,
                                                       "disc_weight": 0.025, "disc_factor": 1.0}},
                             "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 512,
                                          "in_channels": 3, "out_ch": 3, **CFW_WIDTHS,
                                          "attn_resolutions": [], "dropout": 0.0},
                             "image_key": "gt"}},
        "data": {"target": "main.DataModuleFromConfig",
                 "params": {"batch_size": CFW_B, "num_workers": 0, "wrap": True,
                            "train": {"target": "basicsr.data.single_image_dataset."
                                                "SingleImageNPDataset",
                                      "params": {"gt_path": [dump], "crop_size": CFW_SIZE,
                                                 "io_backend": {"type": "disk"}}}}},
    }


def cfw_stage1_files(model, state, root: str, device: str) -> dict:
    """The stage-1 model's files, from the diffusion phase's seeded model:
    a full StableSR-layout checkpoint (``model.diffusion_model.``,
    ``structcond_stage_model.``, ``first_stage_model.``), the VAE alone in
    that layout (``pretrain_vae``), the EMA as the JAX CLI's params pickle
    (``--ckpt``; sampling reads the EMA) and ssl_base.yml's config (flash on)."""
    import pickle

    import torch
    from ssl_tpu_torch.utils.weight_port import params_to_jax

    def host(net, prefix):
        return {prefix + k: v.detach().cpu() for k, v in net.state_dict().items()}

    files = {k: os.path.join(root, name) for k, name in (
        ("full", "stablesr.ckpt"), ("vae", "sd_vae.ckpt"), ("pkl", "stage1.pkl"),
        ("cfg", "ssl_base.json"))}
    vae = host(state.frozen["vae"], "first_stage_model.")
    torch.save({"state_dict": {**host(state.params["unet"], "model.diffusion_model."),
                               **host(state.params["structcond"], "structcond_stage_model."),
                               **vae}, "global_step": 0}, files["full"])
    torch.save({"state_dict": vae}, files["vae"])
    with open(files["pkl"], "wb") as f:
        pickle.dump(params_to_jax("StableSRSSL", state.ema_params), f)
    with open(files["cfg"], "w") as f:
        json.dump(ssl_base_cfg(), f)
    return files


def cfw_import_hold(model, state, files: dict, device: str) -> dict:
    """``model.vae_ckpt`` and ``model.ckpt_path`` on the full checkpoint:
    every imported parameter (UNet, struct-cond encoder, VAE; the EMA a copy)
    bit for bit the original's, and one denoiser output, cuDNN
    deterministic and TF32 off, bit for bit the original model's."""
    import torch
    from ssl_tpu_torch.diffusion.main import build_from_config

    cfg = ssl_base_cfg()
    cfg["model"].update(vae_ckpt=files["full"], ckpt_path=files["full"])
    t0 = time.perf_counter()
    imported = build_from_config(cfg)
    new = imported.init_state(seed=1, device=device)
    import_s = time.perf_counter() - t0
    n = 0
    for name, a, b in (("unet", state.params["unet"], new.params["unet"]),
                       ("structcond", state.params["structcond"], new.params["structcond"]),
                       ("unet ema", new.params["unet"], new.ema_params["unet"]),
                       ("vae", state.frozen["vae"], new.frozen["vae"])):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            n += 1
            if not torch.equal(x, y):
                fail(f"cfw: the imported {name} parameter {key} differs from the original")
    gen = torch.Generator(device=device).manual_seed(7)
    z = torch.randn((1, 4, CFW_SIZE // 8, CFW_SIZE // 8), generator=gen, device=device)
    t = torch.full((1,), 500, device=device)
    ctx = state.params["null_context"][None].detach()
    with torch.no_grad(), deterministic_float32():
        want = model.apply_model(state.params, z, t, ctx, z)
        got = imported.apply_model(new.params, z, t, ctx, z)
    if not torch.equal(got, want):
        fail(f"cfw: the imported model's denoiser output differs by up to "
             f"{float((got - want).abs().max())}")
    del imported, new
    return {"tensors_bit_for_bit": n, "denoiser_bit_for_bit": True, "import_s": import_s,
            "full_ckpt_gb": os.path.getsize(files["full"]) / 1e9}


def cfw_dump(files: dict, root: str, device: str) -> tuple[str, dict]:
    """CFW_GT seeded GT PNGs of CFW_SIZE^2 through the dump entry point
    (``ssl_tpu_torch.scripts.gt_input_output``, CFW_DUMP_STEPS DDPM steps)."""
    import numpy as np
    import torch
    from ssl_tpu_torch.scripts import gt_input_output
    from ssl_tpu_torch.utils.img_util import imread, imwrite

    gt_dir, dump = os.path.join(root, "gt"), os.path.join(root, "dump")
    os.makedirs(gt_dir)
    gen = torch.Generator(device=device).manual_seed(40)
    for i in range(CFW_GT):
        img = smooth_picture(CFW_SIZE, CFW_SIZE, gen, device)
        imwrite(np.ascontiguousarray(img.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]),
                os.path.join(gt_dir, f"{i:04d}.png"))
    t0 = time.perf_counter()
    names = gt_input_output.main(["--config", files["cfg"], "--ckpt", files["pkl"], "--gt_dir",
                                  gt_dir, "--outdir", dump, "--ddpm_steps", str(CFW_DUMP_STEPS),
                                  "--seed", "0"] + (["--device", device] if device != "cuda"
                                                    else []))
    dump_s = time.perf_counter() - t0
    latent_shape = (CFW_SIZE // 8, CFW_SIZE // 8, 4)
    for name in names:
        z = np.load(os.path.join(dump, "latents", name[:-4] + ".npy"))
        sample = imread(os.path.join(dump, "samples", name), float32=False)
        if z.shape != latent_shape or not np.isfinite(z).all() or sample.shape != (
                CFW_SIZE, CFW_SIZE, 3):
            fail(f"cfw: the dump wrote a latent {z.shape} (finite: {np.isfinite(z).all()}) "
                 f"and a sample {sample.shape} for {name}")
    counts = {sub: len(os.listdir(os.path.join(dump, sub)))
              for sub in ("gts", "inputs", "latents", "samples")}
    if set(counts.values()) != {CFW_GT}:
        fail(f"cfw: the dump's folders hold {counts}")
    return dump, {"images": CFW_GT, "ddpm_steps": CFW_DUMP_STEPS, "wall_s": dump_s,
                  "s_per_image": dump_s / CFW_GT}


def cfw_cli(base: str, root: str, device: str) -> dict:
    """The CFW CLI on the reference-schema file with the overrides
    CFW_OVERRIDES: CFW_CLI_STEPS steps (K2 CFW_K2 a step, losses finite),
    ``cfw_state_{n}.pkl`` reloaded into a fresh state bit for bit, the
    weights moved and the frozen encoder the imported one's, then
    ``--resume`` to CFW_RESUME_STEPS.  Returns the checks and K2's launches
    by kernel over both runs."""
    import types

    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion import cfw_train
    from ssl_tpu_torch.ops import attention_cuda

    logdir = os.path.join(root, "cfw_logs")
    steps, logs, ms = [], [], []
    clock = [time.perf_counter()]

    def on_step(step, out, state):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        ms.append(1e3 * (now - clock[0]))
        steps.append({"fwd": attention_cuda.launches - sum(s["fwd"] for s in steps),
                      "bwd": attention_cuda.bwd_launches - sum(s["bwd"] for s in steps)})
        logs.append({k: float(v) for k, v in out.items()})
        clock[0] = time.perf_counter()

    def run(extra, resume=None):
        args = types.SimpleNamespace(base=base, logdir=logdir, data_root=None, resume=resume,
                                     device=device, overrides=CFW_OVERRIDES + extra)
        clock[0] = time.perf_counter()
        return cfw_train.train(args, on_step)

    reset_k2_counts()
    t0 = time.perf_counter()
    first = run([f"train.max_steps={CFW_CLI_STEPS}", f"train.save_every={CFW_CLI_STEPS}"])
    wall = time.perf_counter() - t0
    tm = cfw_train.CFWTrainModel(cfw_train.load_cfw_config(base, CFW_OVERRIDES))
    fresh = tm.init_state(seed=1, device=device)
    moved = any(not torch.equal(a, b) for a, b in zip(
        cfw_train.trainable(first.net)[:4], cfw_train.trainable(fresh.net)[:4]))
    same_encoder = all(torch.equal(a, b) for a, b in zip(first.net.encoder.state_dict().values(),
                                                         fresh.net.encoder.state_dict().values()))
    cfw_train.load_cfw_state(os.path.join(logdir, f"cfw_state_{CFW_CLI_STEPS}.pkl"), fresh)
    n = 0
    for a, b in ((first.net, fresh.net), (first.ema, fresh.ema), (first.net_d, fresh.net_d)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            n += 1
            if not torch.equal(x, y):
                fail(f"cfw: the reloaded {key} differs from the saved state")
    for a, b in ((first.opt_g, fresh.opt_g), (first.opt_d, fresh.opt_d)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        for i in sa:
            for key in sa[i]:
                n += 1
                if not torch.equal(sa[i][key], sb[i][key]):
                    fail(f"cfw: a reloaded Adam moment ({i}.{key}) differs")
    if fresh.step != CFW_CLI_STEPS or not moved or not same_encoder:
        fail(f"cfw: step {fresh.step}, the decoder moved: {moved}, the frozen encoder is the "
             f"imported VAE's: {same_encoder}")
    del fresh
    t0 = time.perf_counter()
    resumed = run([f"train.max_steps={CFW_RESUME_STEPS}", f"train.save_every={CFW_RESUME_STEPS}"],
                  os.path.join(logdir, f"cfw_state_{CFW_CLI_STEPS}.pkl"))
    resumed_wall = time.perf_counter() - t0
    kernels = k2_counts()
    if resumed.step != CFW_RESUME_STEPS or not os.path.isfile(
            os.path.join(logdir, f"cfw_{CFW_RESUME_STEPS}.pkl")):
        fail(f"cfw: the resumed CLI ended at step {resumed.step}")
    if any(not np.isfinite(v) for rec in logs for v in rec.values()) or \
            sorted(logs[0]) != ["l_d", "l_g_gan", "l_pix", "l_total"]:
        fail(f"cfw: the CLI logged {logs}")
    if any(s != CFW_K2 for s in steps):
        fail(f"cfw: K2 launches per step {steps}, expected {CFW_K2}")
    idle = [k_ for k_ in CFW_KERNELS if kernels.get(k_, 0) == 0]
    if idle:
        fail(f"cfw: K2 kernels {idle} were not launched in the CLI's steps: {kernels}")
    del first, resumed
    return {"steps": CFW_RESUME_STEPS, "logs": logs, "ms_per_step": ms, "wall_s": wall,
            "resumed_wall_s": resumed_wall, "k2_per_step": CFW_K2,
            "reloaded_tensors_bit_for_bit": n, "pkl": os.path.join(logdir,
                                                                  f"cfw_{CFW_RESUME_STEPS}.pkl"),
            "launches": kernels}


class capture_attention:
    """Record the (q, k, v) of the VAE's mid attention calls that carry a
    gradient (the decoder's), detached copies, while the block runs."""

    def __enter__(self):
        from ssl_tpu_torch.diffusion import vae
        self.vae, self.orig, self.calls = vae, vae.sdp_attention, []

        def spy(q, k, v, scale, use_flash):
            self.calls.append({"qkv": [t.detach().clone() for t in (q, k, v)], "scale": scale,
                               "grad": q.requires_grad})
            return self.orig(q, k, v, scale, use_flash)
        vae.sdp_attention = spy
        return self

    def __exit__(self, *exc):
        self.vae.sdp_attention = self.orig


def hold_k2_cfw(call: dict, seed: int, device: str) -> dict:
    """K2 on one captured call's q, k, v: float32, the forward's o (rtol 1e-4,
    atol 1e-5 of its largest value) and lse (1e-5, 1e-5), and with the
    call's gradient the backward's dq, dk, dv on a seeded dO against
    ``flash_attn_bwd_reference`` (BWD_RTOL, BWD_ATOL of the largest value,
    BWD_REL_L2); bf16, against the float32 plain version on the inputs
    upcast, each output at most BF16_PLAIN_RATIO times the error of the plain
    bf16 version (``sdp_attention_reference`` / ``flash_attn_bwd_reference``
    on the bf16 inputs, the kernels' rounding points) on the same inputs.
    phase_k2_d512_bf16's absolute bounds (BF16_FWD_REL_L2, BF16_BWD_REL_L2),
    set on synthetic inputs, are reported beside: on the CFW decoder's own
    q, k, v after the stage-1 model's training steps the plain bf16
    backward's dq was itself 1.2e-2 off float32 (PERF.md §6), so no bf16
    implementation of the contract meets them there.  The kernel's distance
    to the plain bf16 version is reported too."""
    import torch
    from torch_attention_cases import BF16_BWD_REL_L2, BF16_FWD_REL_L2, BF16_PLAIN_RATIO
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                             sdp_attention_reference)

    q, k, v = call["qkv"]
    scale = call["scale"]
    b, n, h, d = q.shape
    out = {"b_heads_n_d": [b, h, n, d], "dtype": str(q.dtype).removeprefix("torch.")}
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    ref_o, ref_lse = sdp_attention_reference(q32, k32, v32, scale), attention_lse_reference(
        q32, k32, scale)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        plain = sdp_attention_reference(q, k, v, scale)
        out["o_rel_l2"], out["plain_o_rel_l2"] = rel_l2(o, ref_o), rel_l2(plain, ref_o)
        out["o_rel_l2_vs_plain_bf16"] = rel_l2(o, plain)
        out["o_within_absolute"] = out["o_rel_l2"] <= BF16_FWD_REL_L2
        if out["o_rel_l2"] > BF16_PLAIN_RATIO * out["plain_o_rel_l2"]:
            fail(f"cfw: K2 bf16 forward {out}")
        out["lse_max_abs_err"] = check_close("cfw K2 bf16 lse", lse,
                                             attention_lse_reference(q, k, scale), 1e-5, 1e-5)
    else:
        out["o_max_abs_err"] = check_close("cfw K2 o", o, ref_o, 1e-4,
                                           1e-5 * float(ref_o.abs().max()))
        out["lse_max_abs_err"] = check_close("cfw K2 lse", lse, ref_lse, 1e-5, 1e-5)
        out["o_rel_l2"] = rel_l2(o, ref_o)
    if not call["grad"]:
        return out
    do = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(seed),
                     device=device).to(q.dtype)
    got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
    if bf16:
        ref = flash_attn_bwd_reference(q32, k32, v32, ref_o, ref_lse, do.float(), scale)
        plain = flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
        for g_name, g, r, p_ in zip(("dq", "dk", "dv"), got, ref, plain):
            out[f"{g_name}_rel_l2"], out[f"plain_{g_name}_rel_l2"] = rel_l2(g, r), rel_l2(p_, r)
            out[f"{g_name}_rel_l2_vs_plain_bf16"] = rel_l2(g, p_)
            out[f"{g_name}_within_absolute"] = out[f"{g_name}_rel_l2"] <= BF16_BWD_REL_L2
            if out[f"{g_name}_rel_l2"] > BF16_PLAIN_RATIO * out[f"plain_{g_name}_rel_l2"]:
                fail(f"cfw: K2 bf16 backward {g_name}: {out}")
    else:
        ref = flash_attn_bwd_reference(q, k, v, ref_o, ref_lse, do, scale)
        for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
            out[f"{g_name}_max_abs_err"] = check_close(
                f"cfw K2 bwd {g_name}", g, r, BWD_RTOL, BWD_ATOL * float(r.abs().max()))
            out[f"{g_name}_rel_l2"] = rel_l2(g, r)
            if out[f"{g_name}_rel_l2"] > BWD_REL_L2:
                fail(f"cfw: K2 backward {g_name}: {out}")
    return out


def cfw_weights_hold(got, ref, grads, lr: float) -> dict:
    """The trained weights of two runs of one step within lr/5, where the
    gradient is at rounding-noise level (below CFW_GRAD_FLOOR of the
    tensor's largest, or of the net's where the whole tensor is below that)
    within 2.2 lr, on at most CFW_NOISE_SHARE of the elements
    (tests/test_torch_cfw.py::check_trained)."""
    top = max(float(g.abs().max()) for g in grads)
    worst, noisy, total = 0.0, 0, 0
    for x, r, g in zip(got, ref, grads):
        g = g.abs()
        own = float(g.max())
        floor = g < CFW_GRAD_FLOOR * (own if own >= CFW_GRAD_FLOOR * top else top)
        atol = lr / 5 + 2 * lr * floor.float()
        diff = (x - r).abs()
        worst = max(worst, float((diff / atol).max()))
        noisy += int(floor.sum())
        total += r.numel()
    if worst > 1 or noisy > CFW_NOISE_SHARE * total:
        fail(f"cfw: the flash route's trained weights are {worst} of their bound from the "
             f"plain route's ({noisy} of {total} elements at rounding-noise level)")
    return {"worst_of_bound": worst, "noise_share": noisy / total}


def cfw_steps(base: str, dump: str, device: str) -> dict:
    """In process, on the dump's first batch: one float32 step with the
    flash switch on against the same step with it off (cuDNN deterministic,
    TF32 off: losses within TRAIN_LOG_RTOL, trained weights by
    ``cfw_weights_hold``), K2 held on the step's own q, k, v (the encoder's
    forward, the decoder's forward and backward; ``hold_k2_cfw``); one bf16
    step, K2's bf16 kernels held likewise; then ms per step in turns CFW_TURNS, CFW_TIME_STEPS
    timed steps a turn after the held one, with peak memory and K2's
    launches a step by kernel."""
    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion import cfw_train
    from ssl_tpu_torch.ops import attention_cuda

    ds = cfw_train.CFWTripletDataset.from_root(dump, crop_size=CFW_SIZE)
    items = [ds[i] for i in range(CFW_B)]
    batch = {k: torch.from_numpy(np.ascontiguousarray(
        np.stack([it[k] for it in items]).transpose(0, 3, 1, 2))).to(device) for k in items[0]}
    runs, holds, launches, logs = {}, {}, {}, {}
    for route, extra in (("flash", []), ("plain", ["vae.use_flash_attention=false"]),
                         ("bf16", ["vae.compute_dtype=bfloat16"])):
        tm = cfw_train.CFWTrainModel(cfw_train.load_cfw_config(base, CFW_OVERRIDES + extra))
        state = tm.init_state(seed=0, device=device)
        grads = []
        if route == "plain":
            state.opt_g.register_step_pre_hook(lambda *a, s=state: grads.extend(
                p.grad.detach().clone() for p in cfw_train.trainable(s.net)))
        reset_k2_counts()
        with capture_attention() as cap, deterministic_float32():
            state, out = tm.train_step(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        launches[route] = k2_counts()
        logs[route] = {k: float(v) for k, v in out.items()}
        runs[route] = {"tm": tm, "state": state, "grads": grads}
        if route != "plain":      # the encoder's call, and the decoder's (its first of two)
            calls = [next(c for c in cap.calls if c["grad"] is g) for g in (False, True)]
            holds[route] = dict(zip(("encoder", "decoder"),
                                    (hold_k2_cfw(c, 50 + i, device) for i, c in enumerate(calls))))
    if launches["plain"]["k2_fwd"] or launches["plain"]["k2_bwd"]:
        fail(f"cfw: the plain route launched K2: {launches['plain']}")
    for route in ("flash", "bf16"):
        if {"fwd": launches[route]["k2_fwd"], "bwd": launches[route]["k2_bwd"]} != CFW_K2:
            fail(f"cfw: {route} step: K2 launches {launches[route]}, expected {CFW_K2}")
        if not all(np.isfinite(v) for v in logs[route].values()):
            fail(f"cfw: the {route} step logged {logs[route]}")
    log_err = {k: abs(logs["flash"][k] - v) / abs(v) for k, v in logs["plain"].items()}
    if max(log_err.values()) > TRAIN_LOG_RTOL:
        fail(f"cfw: the flash and plain steps' logs differ by {log_err}")
    lr = runs["plain"]["tm"].optim_g.get("lr", 1e-4)
    weights = cfw_weights_hold(
        [p.detach() for p in cfw_train.trainable(runs["flash"]["state"].net)],
        [p.detach() for p in cfw_train.trainable(runs["plain"]["state"].net)],
        runs["plain"]["grads"], lr)
    del runs["plain"]
    if device == "cuda":
        torch.cuda.empty_cache()

    ms = {"float32": [], "bfloat16": []}
    peak = {}
    for dtype in CFW_TURNS:
        run = runs["bf16" if dtype == "bfloat16" else "flash"]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(CFW_TIME_STEPS):
            t0 = time.perf_counter()
            run["tm"].train_step(run["state"], batch)
            if device == "cuda":
                torch.cuda.synchronize()
            ms[dtype].append(1e3 * (time.perf_counter() - t0))
        if device == "cuda":
            peak[dtype] = torch.cuda.max_memory_allocated() / 1e9
    del runs
    by_kernel = {route: {k_: c for k_, c in counts.items()
                         if c and k_.startswith("flash_attn")} for route, counts in launches.items()
                 if route != "plain"}
    return {"log_rel_err_flash_vs_plain": log_err, "weights_flash_vs_plain": weights,
            "logs": logs, "k2_holds": holds, "k2_per_step_by_kernel": by_kernel,
            "ms_per_step": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms,
            "peak_mem_gb": peak, "launches_bf16": launches["bf16"]}


def cfw_serve(model, state, files: dict, cfw_pkl: str, root: str, device: str) -> dict:
    """``test_cli --vqgan_ckpt`` on CFW_TEST_LQ seeded LQ PNGs of SERVE_LQ^2
    (CFW_TEST_STEPS DDPM steps, no color fix); then the same requests in
    process through ``restore`` on the phase's model (the pickle's weights)
    from the CLI's generator seed, with the CFW decoder and with the plain
    VAE: the CLI's images within one uint8 level of the in-process CFW ones
    on at most RE_TIE_SHARE of the values, each different from the plain
    decode's, the decodes finite; ms per image of each."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ssl_tpu_torch.diffusion import test_cli
    from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, imwrite, tensor2img

    lq_dir, out_dir = os.path.join(root, "lq"), os.path.join(root, "restored")
    os.makedirs(lq_dir)
    gen = torch.Generator(device=device).manual_seed(41)
    for i in range(CFW_TEST_LQ):
        img = smooth_picture(SERVE_LQ, SERVE_LQ, gen, device)
        imwrite(np.ascontiguousarray(img.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]),
                os.path.join(lq_dir, f"lq{i}.png"))
    t0 = time.perf_counter()
    test_cli.main(["--config", files["cfg"], "--ckpt", files["pkl"], "--init-img", lq_dir,
                   "--outdir", out_dir, "--ddpm_steps", str(CFW_TEST_STEPS), "--colorfix_type",
                   "nofix", "--vqgan_ckpt", cfw_pkl] + (["--device", device] if device != "cuda"
                                                         else []))
    cli_s = time.perf_counter() - t0
    cfw = test_cli.load_cfw(json.load(open(files["cfg"])), cfw_pkl, device)
    result = {"cli_wall_s": cli_s, "images": CFW_TEST_LQ, "ddpm_steps": CFW_TEST_STEPS}
    imgs = {}
    for route, net in (("cfw", cfw), ("plain", None)):
        gen = torch.Generator(device=device).manual_seed(42)
        ms = []
        imgs[route] = []
        for i in range(CFW_TEST_LQ):
            lq = img2tensor(img2array(imread(os.path.join(lq_dir, f"lq{i}.png"))))[None]
            lq_up = F.interpolate(lq, size=(4 * SERVE_LQ, 4 * SERVE_LQ), mode="bicubic",
                                  align_corners=False).to(device)
            t0 = time.perf_counter()
            img = test_cli.restore(model, state, lq_up, gen, "ddpm", CFW_TEST_STEPS, 0, "nofix",
                                   cfw=net)
            if device == "cuda":
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if not bool(torch.isfinite(img).all()):
                fail(f"cfw: the {route} decode of lq{i} is not finite")
            imgs[route].append(tensor2img(img))
        result[f"ms_per_image_{route}"] = ms
    for i in range(CFW_TEST_LQ):
        cli = imread(os.path.join(out_dir, f"lq{i}.png"), float32=False)
        levels = np.abs(cli.astype(int) - imgs["cfw"][i].astype(int))
        share = float((levels > 0).mean())
        plain_diff = float(np.abs(cli.astype(int) - imgs["plain"][i].astype(int)).mean())
        result[f"lq{i}"] = {"cli_vs_in_process_levels": int(levels.max()),
                            "share_off": share, "mean_abs_diff_vs_plain": plain_diff}
        if levels.max() > 1 or share > RE_TIE_SHARE or plain_diff == 0:
            fail(f"cfw: test_cli --vqgan_ckpt's lq{i}: {result[f'lq{i}']}")
    return result


def phase_cfw(model, state, device: str = "cuda"):
    """StableSR's stage 2 at full width (see the module docstring, 8b).
    Returns K2's launches by kernel on the CFW CLI's steps (float32) and on
    the in-process bf16 step."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="cfw_smoke_") as root:
        t0 = time.perf_counter()
        files = cfw_stage1_files(model, state, root, device)
        files_s = time.perf_counter() - t0
        imported = cfw_import_hold(model, state, files, device)
        if device == "cuda":
            torch.cuda.empty_cache()
        dump, dumped = cfw_dump(files, root, device)
        base = os.path.join(root, "autoencoder_kl_64x64x4_resi.json")
        with open(base, "w") as f:
            json.dump(cfw_reference_cfg(files["vae"], dump), f)
        cli = cfw_cli(base, root, device)
        if device == "cuda":
            torch.cuda.empty_cache()
        steps = cfw_steps(base, dump, device)
        if device == "cuda":
            torch.cuda.empty_cache()
        served = cfw_serve(model, state, files, cli.pop("pkl"), root, device)
    emit({"phase": "cfw", "config": "configs/autoencoder/autoencoder_kl_64x64x4_resi.yaml "
                                    "(reference schema) + " + " ".join(CFW_OVERRIDES),
          "stage1": "options/diffusion/ssl_base.yml", "widths": CFW_WIDTHS, "size": CFW_SIZE,
          "batch": CFW_B, "d": {"type": "NLayerDiscriminator", "ndf": 64, "n_layers": 3},
          "reduced": {"max_steps": ["(reference: Lightning's)", CFW_RESUME_STEPS],
                      "dump": f"{CFW_GT} GT images, {CFW_DUMP_STEPS} DDPM steps (200)",
                      "test_cli": f"{CFW_TEST_LQ} images, {CFW_TEST_STEPS} DDPM steps (200)"},
          "files_s": files_s, "import": imported, "dump": dumped, "cli": cli, "steps": steps,
          "serve": served, "card": card() if device == "cuda" else None})
    return {"cfw_cli": cli["launches"], "cfw_bf16_step": steps["launches_bf16"]}


def profiled_launches(fn) -> int:
    """Device kernels one call of ``fn`` launches, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def k2_counts() -> dict:
    from ssl_tpu_torch.ops import attention_cuda
    return {"k2_fwd": attention_cuda.launches, "k2_bwd": attention_cuda.bwd_launches,
            **attention_cuda.fwd_kernel_launches, **attention_cuda.bwd_kernel_launches}


def reset_k2_counts() -> None:
    from ssl_tpu_torch.ops import attention_cuda
    attention_cuda.launches = attention_cuda.bwd_launches = 0
    for counts in (attention_cuda.fwd_kernel_launches, attention_cuda.bwd_kernel_launches):
        counts.update(dict.fromkeys(counts, 0))


def bf16_train_cli(device: str = "cuda") -> dict:
    """BF16_CLI_STEPS StableSR-SSL mini-steps through the training CLI with
    ``model.use_flash_attention=true model.compute_dtype=bfloat16`` as
    overrides, on fresh ``diffusion_cli_fixtures`` data (the shipped
    checkpoint and preview intervals, so none falls in the run): losses
    finite, the weights moved after the last mini-step only, per mini-step K1
    once and K2 TRAIN_K2_FWD / TRAIN_K2_BWD times, every one a bf16 kernel,
    each bf16 kernel launched."""
    import tempfile
    import types

    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion import main as dmain
    from ssl_tpu_torch.diffusion.ddpm_ssl import StableSRSSL, trainable
    from ssl_tpu_torch.ops import attention_cuda, ssg_cuda

    per_step_expected = {"k1": 1, "k2_fwd": TRAIN_K2_FWD, "k2_bwd": TRAIN_K2_BWD}
    with tempfile.TemporaryDirectory(prefix="diffusion_bf16_smoke_") as root:
        d, _ = diffusion_cli_fixtures(os.path.join(root, "data"), device)
        cfg = ssl_base_train_cfg(d)
        cfg["train"].update(max_steps=BF16_CLI_STEPS, save_every=1000, image_every=1000)
        cfg_path = os.path.join(root, "ssl_base.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        records, steps, live = [], [], {}
        call = StableSRSSL.train_step

        def counts():
            return {"k1": ssg_cuda.launches, **k2_counts()}

        def step(self, state, batch, draws=None):
            if "start" not in live:
                live["start"] = [p.detach().clone() for p in trainable(state.params)]
                live["dtype"] = state.params["unet"].dtype
            before = counts()
            out = call(self, state, batch, draws)
            steps.append({k: v - before[k] for k, v in counts().items()})
            return out

        def on_iteration(record, state, degrader):
            moved = not all(torch.equal(a, p) for a, p in zip(live["start"],
                                                               trainable(state.params)))
            records.append(dict(record, moved=moved))

        ssg_cuda.launches = 0
        reset_k2_counts()
        StableSRSSL.train_step = step
        args = types.SimpleNamespace(
            base=cfg_path, logdir=os.path.join(root, "logs"), device=device, resume=None,
            overrides=["model.use_flash_attention=true", "model.compute_dtype=bfloat16"])
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            dmain.train(args, on_iteration)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            StableSRSSL.train_step = call
        launches = {k: v for k, v in counts().items() if "_bf16" in k or k in per_step_expected}
        f32_kernels = sum(c for k, c in counts().items() if k.startswith("flash_attn")
                          and not k.endswith("_bf16"))
    if live.get("dtype") != torch.bfloat16:
        fail(f"diffusion_bf16: the CLI with the override built a UNet in {live.get('dtype')}")
    if [r["step"] for r in records] != list(range(1, BF16_CLI_STEPS + 1)):
        fail(f"diffusion_bf16: the CLI ran mini-steps {[r['step'] for r in records]}")
    for r in records:
        if not all(np.isfinite(v) for v in r["logs"].values()):
            fail(f"diffusion_bf16: CLI mini-step {r['step']} logged {r['logs']}")
        if r["moved"] != (r["step"] == BF16_CLI_STEPS):
            fail(f"diffusion_bf16: after CLI mini-step {r['step']} the weights "
                 f"{'moved' if r['moved'] else 'did not move'}")
    if any({k: s_[k] for k in per_step_expected} != per_step_expected for s_ in steps):
        fail(f"diffusion_bf16: CLI launches per mini-step {steps}, expected {per_step_expected}")
    idle = [k for k, c in launches.items() if c == 0]
    if idle or f32_kernels:
        fail(f"diffusion_bf16: the CLI's bf16 kernels {idle} never launched, or {f32_kernels} "
             f"float32 K2 launches: {launches}")
    warm = [r["iter_s"] for r in records[1:-1]]
    return {"mini_steps": BF16_CLI_STEPS, "wall_s": wall,
            "ms_first": 1e3 * records[0]["iter_s"], "ms_warm_mean": 1e3 * sum(warm) / len(warm),
            "ms_applying": 1e3 * records[-1]["iter_s"],
            "data_wait_ms_mean": 1e3 * sum(r["data_s"] for r in records[1:]) / (len(records) - 1),
            "degrader_ms_mean": 1e3 * sum(r["degrade_s"] for r in records) / len(records),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses_last": records[-1]["logs"], "launches": launches}


def phase_diffusion_bf16(model, state):
    """StableSR-SSL under ``model.compute_dtype: bfloat16`` at the full width
    of options/diffusion/ssl_base.yml, against the float32 model of
    ``phase_diffusion`` (the same seeded weights, its zero-init layers drawn
    the same way): the UNet eps and the VAE decode (TF32 off for the
    float32 side), an E2E_LQ request on the bf16 K2 and bf16 plain routes
    against the float32 K2 route, SERVE_SIZE requests of SERVE_STEPS steps
    and mini-steps at TRAIN_SIZE, batch TRAIN_B (after a warm-up mini-step
    each) in turns (BF16_TURNS) with their times, peak memory (both models
    resident) and working memory (the peak above what was resident), device
    launches a denoising step, the mini-step's UNet gradient against
    float32's, and ``bf16_train_cli``.
    Returns the bf16 K2 launches of the serving requests, the in-process
    mini-steps and the CLI, by kernel."""
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import latent_shape, trainable
    from ssl_tpu_torch.diffusion.main import build_from_config
    from ssl_tpu_torch.diffusion.test_cli import restore

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    cfg = ssl_base_cfg()
    cfg["model"]["compute_dtype"] = "bfloat16"
    model16 = build_from_config(cfg)
    state16 = model16.init_state(seed=0)
    redraw_zero_init(state16)
    nets16 = (state16.params["unet"], state16.params["structcond"], state16.frozen["vae"].encoder,
              state16.frozen["vae"].decoder)
    if any(n.dtype != torch.bfloat16 for n in nets16) or any(
            p.dtype != torch.float32 for n in nets16 for p in n.parameters()):
        fail("diffusion_bf16: compute_dtype did not reach every net, or a parameter is not fp32")
    same = all(torch.equal(a, b) for a, b in zip(
        [*trainable(state.params), *state.frozen["vae"].parameters()],
        [*trainable(state16.params), *state16.frozen["vae"].parameters()]))
    if not same:
        fail("diffusion_bf16: the bf16 model's weights differ from the float32 model's")
    setup_s = time.perf_counter() - t0
    routes = {"bfloat16": (model16, state16), "float32": (model, state)}

    # the UNet eps and the VAE decode, bf16 against float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
    outs = {}
    with torch.no_grad():
        for dtype, (m_, st) in routes.items():
            p = m_.infer_params(st)
            outs[dtype] = (m_.apply_model(p, z, torch.full((1,), 500, device="cuda"),
                                          p["null_context"][None], z),
                           m_.decode(st.frozen["vae"], z))
    nets = {}
    for i, name in enumerate(("unet_eps", "vae_decode")):
        got, ref = outs["bfloat16"][i], outs["float32"][i]
        if got.dtype != torch.float32 or not bool(torch.isfinite(got).all()):
            fail(f"diffusion_bf16: the bf16 {name} is {got.dtype} or not finite")
        nets[name] = {"max_abs_of_scale": float((got - ref).abs().max() / ref.abs().max()),
                      "rel_l2": rel_l2(got, ref), "shape": list(got.shape)}
    del outs
    if max(v["max_abs_of_scale"] for v in nets.values()) >= BF16_NET_BOUND:
        fail(f"diffusion_bf16: bf16 against float32 {nets} (bound {BF16_NET_BOUND} of scale)")

    # an E2E_LQ request: bf16 K2 and bf16 plain routes against the float32 K2 route
    lq_up = lq_image(E2E_LQ, 4 * E2E_LQ, seed=1)
    e2e, e2e_launches = {}, {}
    for route, (dtype, flash) in {"bf16_k2": ("bfloat16", True), "bf16_plain": ("bfloat16", False),
                                  "f32_k2": ("float32", True)}.items():
        m_, st = routes[dtype]
        for mod in flash_modules(st):
            mod.use_flash_attention = flash
        reset_k2_counts()
        e2e[route] = restore(m_, st, lq_up, torch.Generator(device="cuda").manual_seed(7), "ddpm",
                             E2E_STEPS, colorfix="nofix")
        torch.cuda.synchronize()
        e2e_launches[route] = {k: c for k, c in k2_counts().items() if c}
        for mod in flash_modules(st):
            mod.use_flash_attention = True
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if e2e_launches["bf16_k2"].get("k2_fwd") != E2E_K2_LAUNCHES or any(
            k.startswith("flash_attn") and not k.endswith("_bf16")
            for k in e2e_launches["bf16_k2"]):
        fail(f"diffusion_bf16: K2 on the bf16 route {e2e_launches['bf16_k2']}, expected "
             f"{E2E_K2_LAUNCHES} bf16 launches")
    ref = e2e["f32_k2"]
    e2e_rel = {r: rel_l2(e2e[r], ref) for r in ("bf16_k2", "bf16_plain")}
    if not bool(torch.isfinite(e2e["bf16_k2"]).all()) or \
            e2e_rel["bf16_k2"] > BF16_E2E_RATIO * e2e_rel["bf16_plain"]:
        fail(f"diffusion_bf16: the {4 * E2E_LQ}^2 request's relative L2 to float32 {e2e_rel} "
             f"(the K2 route at most {BF16_E2E_RATIO}x the plain route's)")
    del e2e

    # serving requests in turns
    images = [lq_image(SERVE_LQ, SERVE_SIZE, seed=10 + i) for i in range(len(BF16_TURNS))]
    serve = {dtype: [] for dtype in routes}
    reset_k2_counts()
    for dtype, lq_up in zip(BF16_TURNS, images):
        m_, st = routes[dtype]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = k2_counts()
        timings = {}
        t0 = time.perf_counter()
        img = restore(m_, st, lq_up, torch.Generator(device="cuda").manual_seed(42), "ddpm",
                      SERVE_STEPS, timings=timings)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: c - before[k] for k, c in k2_counts().items()}
        if tuple(img.shape) != (1, 3, SERVE_SIZE, SERVE_SIZE) or \
                not bool(torch.isfinite(img).all()):
            fail(f"diffusion_bf16: the {dtype} request gave {tuple(img.shape)} or non-finite "
                 "values")
        expected = K2_PER_REQUEST + SERVE_STEPS * K2_PER_STEP
        wrong = [k for k, c in launched.items() if c and k.startswith("flash_attn")
                 and k.endswith("_bf16") != (dtype == "bfloat16")]
        if launched["k2_fwd"] != expected or wrong:
            fail(f"diffusion_bf16: a {dtype} request launched K2 {launched}")
        serve[dtype].append({"ms": ms, "ms_per_step": 1e3 * timings["sample"] / SERVE_STEPS,
                             "vae_encode_ms": 1e3 * timings["encode"],
                             "vae_decode_ms": 1e3 * timings["decode"],
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "working_mem_gb":
                                 (torch.cuda.max_memory_allocated() - resident) / 1e9})
    serve_kernels = {k: c for k, c in k2_counts().items() if k.endswith("_bf16")
                     and k.startswith("flash_attn_fwd")}
    if not all(serve_kernels.values()):
        fail(f"diffusion_bf16: bf16 forward kernels never launched in serving: {serve_kernels}")
    step_launches = {}
    for dtype, (m_, st) in routes.items():
        p = m_.infer_params(st)
        zz = torch.randn((1, 4, SERVE_SIZE // 8, SERVE_SIZE // 8), device="cuda")

        def one_step():
            with torch.no_grad():
                m_.apply_model(p, zz, torch.full((1,), 500, device="cuda"),
                               p["null_context"][None], zz)
        step_launches[dtype] = profiled_launches(one_step)

    # mini-steps in turns on one batch and one set of draws
    batch = train_batch(TRAIN_SIZE, seed=30)
    gen = torch.Generator(device="cuda").manual_seed(31)
    shape = latent_shape(state.frozen["vae"], TRAIN_B, TRAIN_SIZE, TRAIN_SIZE)
    draws = {"enc_noise": torch.randn((2 * TRAIN_B, *shape[1:]), generator=gen, device="cuda"),
             "t": torch.tensor([1, 3], device="cuda") * (model.sched.num_timesteps // 4),
             "noise": torch.randn(shape, generator=gen, device="cuda")}
    mini, grads, logs = {dtype: [] for dtype in routes}, {}, {}
    train_kernels = {}
    for dtype, (m_, st) in routes.items():       # a warm-up mini-step each, not timed
        m_.train_step(st, batch, draws)
        reset_training(st)
    for dtype in BF16_TURNS:
        m_, st = routes[dtype]
        reset_training(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = k2_counts()
        t0 = time.perf_counter()
        _, out = m_.train_step(st, batch, draws)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: c - before[k] for k, c in k2_counts().items()}
        wrong = [k for k, c in launched.items() if c and k.startswith("flash_attn")
                 and k.endswith("_bf16") != (dtype == "bfloat16")]
        if (launched["k2_fwd"], launched["k2_bwd"]) != (TRAIN_K2_FWD, TRAIN_K2_BWD) or wrong:
            fail(f"diffusion_bf16: a {dtype} mini-step launched K2 {launched}")
        if dtype == "bfloat16":
            for k, c in launched.items():
                if k.endswith("_bf16"):
                    train_kernels[k] = train_kernels.get(k, 0) + c
        values = {k: float(v) for k, v in out.items()}
        if not all(v == v and abs(v) != float("inf") for v in values.values()):
            fail(f"diffusion_bf16: a {dtype} mini-step logged {values}")
        mini[dtype].append({"ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "working_mem_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9})
        if dtype not in grads:
            grads[dtype] = torch.cat([p.grad.flatten() for p in st.params["unet"].parameters()])
            logs[dtype] = values
        reset_training(st)
    if not all(p.grad is None or p.grad.dtype == torch.float32 for p in trainable(state16.params)):
        fail("diffusion_bf16: a bf16 mini-step's gradient is not float32")
    g16, g32 = grads["bfloat16"].double(), grads["float32"].double()
    cos = float(g16 @ g32 / (g16.norm() * g32.norm()))
    if not cos > BF16_GRAD_COS:
        fail(f"diffusion_bf16: the UNet gradient's cosine to float32 is {cos} "
             f"(bound {BF16_GRAD_COS})")
    del grads, g16, g32, model16, state16, nets16, routes, m_, st, p
    torch.cuda.empty_cache()
    cli = bf16_train_cli()
    torch.cuda.empty_cache()

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)
    emit({"phase": "diffusion_bf16", "config": "options/diffusion/ssl_base.yml",
          "compute_dtype": "bfloat16", "use_flash_attention": True, "setup_s": setup_s,
          "nets_vs_float32": nets, "net_bound": BF16_NET_BOUND,
          "e2e": {"size": 4 * E2E_LQ, "steps": E2E_STEPS, "rel_l2_vs_f32_k2": e2e_rel,
                  "ratio_bound": BF16_E2E_RATIO, "k2_launches": e2e_launches},
          "serve": {"size": SERVE_SIZE, "steps": SERVE_STEPS, "turns": list(BF16_TURNS),
                    "requests": serve, "device_launches_per_step": step_launches,
                    "ms_per_request": {k: mean(v, "ms") for k, v in serve.items()},
                    "ms_per_step": {k: mean(v, "ms_per_step") for k, v in serve.items()},
                    "bf16_kernel_launches": serve_kernels},
          "mini_steps": {"size": TRAIN_SIZE, "batch": TRAIN_B, "turns": list(BF16_TURNS),
                         "runs": mini, "ms": {k: mean(v, "ms") for k, v in mini.items()},
                         "logs": logs, "unet_grad_cosine": cos, "cosine_bound": BF16_GRAD_COS,
                         "bf16_kernel_launches": train_kernels},
          "train_cli": cli,
          "reduced": {"serve_requests": f"{len(BF16_TURNS)} in turns, 2 per dtype",
                      "cli_mini_steps": [800000, BF16_CLI_STEPS],
                      "cli_accumulate_grad_batches": [SHIPPED_ACCUMULATE, TRAIN_MINI_STEPS]},
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "card": card()})
    return {"serve": serve_kernels, "mini_steps": train_kernels, "cli": cli["launches"]}


def phase_train():
    import numpy as np
    import torch
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda

    model = build_model(shipped_opt(MAIN_B))
    state = model.init_state(seed=0)
    torch.cuda.reset_peak_memory_stats()
    lq_size = MAIN_GT // SCALE
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        "lq": rng.rand(MAIN_B, 3, lq_size, lq_size).astype(np.float32),
        "gt": rng.rand(MAIN_B, 3, MAIN_GT, MAIN_GT).astype(np.float32),
        "gt_mask": (rng.rand(MAIN_B, 1, MAIN_GT, MAIN_GT) < 0.25).astype(np.float32)}.items()}
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in (("g", state.net_g), ("d", state.net_d), ("ema", state.net_g_ema))}

    ssg_cuda.launches = 0
    state, logs = model.train_step(state, batch)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_steps = 3
    for _ in range(n_steps):
        state, logs = model.train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    launches = ssg_cuda.launches

    if launches != n_steps + 1:
        fail(f"K1 launched {launches} times in {n_steps + 1} steps, expected one per step")
    wanted = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real", "l_d_fake")
    values = {k: float(logs[k]) for k in wanted if k in logs}
    missing = [k for k in wanted if k not in values]
    if missing:
        fail(f"losses missing from the logs: {missing}")
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"non-finite loss: {values}")
    for name, net in (("g", state.net_g), ("d", state.net_d), ("ema", state.net_g_ema)):
        if all(torch.equal(a, p) for a, p in zip(before[name], net.parameters())):
            fail(f"{name} parameters did not change")
    with torch.no_grad():
        out = state.net_g_ema(batch["lq"])
    if tuple(out.shape) != (MAIN_B, 3, MAIN_GT, MAIN_GT) or not bool(torch.isfinite(out).all()):
        fail(f"EMA generator output {tuple(out.shape)} is wrong or not finite")
    emit({"phase": "train", "model": "ESRGANSSLModel", "batch": MAIN_B, "gt_size": MAIN_GT,
          "steps_timed": n_steps, "ms_per_step": 1e3 * step_s, "imgs_per_s": MAIN_B / step_s,
          "k1_launches": launches, "losses": values, "card": card(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return launches


def bench_opt(dtype: str) -> dict:
    """bench.py:54-116's option dict with its defaults: ``dtype`` "bfloat16"
    gives its bf16 knobs (G's and D's compute_dtype, the SSG's q store and
    stream), "float32" the same dict with those four in float32.  VGG stays
    float32, as bench.py's default; ``remat_policy: none`` and
    ``scan_unroll`` are the JAX option keys, which eager PyTorch accepts and
    has no use for."""
    return {
        "name": "bench", "model_type": "ESRGANSSLModel", "scale": SCALE, "is_train": True,
        "manual_seed": 0, "datasets": {"train": {"gt_size": BENCH_GT}},
        "network_g": {"type": "RRDBNet", "num_feat": 64, "num_block": 23, "num_grow_ch": 32,
                      "remat_policy": "none", "scan_unroll": 23, "compute_dtype": dtype},
        "network_d": {"type": "UNetDiscriminatorSN", "num_feat": 64, "compute_dtype": dtype},
        "path": {},
        "ssl_setting": {"mask_stride": 3, "kernel_size_search": 25, "sigma": 0.004,
                        "kernel_size_window": 9, "generalization": True, "q_store_dtype": dtype,
                        "stream_dtype": dtype, "pair_offsets": True, "impl": "dense",
                        "capacity": BENCH_GT * BENCH_GT // 4},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [50000], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "softmax": False},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": {"conv5_4": 1.0},
                               "perceptual_weight": 1.0, "style_weight": 0, "criterion": "l1",
                               "compute_dtype": "float32"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "loss_weight": 5e-3}}}


def phase_bench(device: str = "cuda"):
    """bench.py's ESRGAN-SSL step (``bench_opt``) through build_model ->
    init_state -> train_step at its bf16 defaults and in float32, in turns,
    on bench.py's uniform batch (batch BENCH_B, gt BENCH_GT, a mask of
    density 0.25, drawn in NCHW): first the bf16 G's image and D's logits
    held against the float32 nets' on the same seeded weights (within 3e-2
    of the float32 output's scale, the JAX contract), then for each a
    warm-up step and BENCH_STEPS timed steps; every loss finite, G, D and the
    EMA moved, K1 once a step in the mode of the run (stream + store on the
    stored route in bf16, float32 in float32) and never the plain forward.
    The runs go in turns (BENCH_TURNS) on the same two models, each with its
    own warm-up step.  Returns the K1 launches by mode name (and the bf16
    store's stream kernel's under ``stream_kernel``) and the runs."""
    import gc

    import numpy as np
    import torch
    from ssl_tpu_torch.losses.ssl_loss import dense_route
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda

    lq_size = BENCH_GT // SCALE
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in {
        "lq": rng.rand(BENCH_B, 3, lq_size, lq_size).astype(np.float32),
        "gt": rng.rand(BENCH_B, 3, BENCH_GT, BENCH_GT).astype(np.float32),
        "gt_mask": (rng.rand(BENCH_B, 1, BENCH_GT, BENCH_GT) < 0.25).astype(np.float32)}.items()}
    dtypes = ("bfloat16", "float32")
    with torch.no_grad():
        nets = {}
        for dt in dtypes:
            state = build_model(bench_opt(dt), device=device).init_state(seed=0)
            net_d = state.net_d.eval()          # eval: the power iteration stores nothing
            nets[dt] = (state.net_g(batch["lq"]), net_d(batch["gt"]))
            del state, net_d
        held = {}
        for i, key in enumerate(("g_image", "d_logits")):
            got, ref = nets["bfloat16"][i], nets["float32"][i]
            if got.dtype != torch.float32:
                fail(f"bench: the bf16 {key} is {got.dtype}, not float32")
            held[key] = float((got - ref).abs().max() / ref.abs().max())
            if not held[key] < 3e-2:
                fail(f"bench: the bf16 {key} lies {held[key]} of its scale off float32's")
        del nets
    gc.collect()
    torch.cuda.empty_cache()

    runs, launches_by = {}, {}
    plain_on_card = []
    plain = ssg_cuda.ssl_loss_sums_reference

    def counted_plain(sr, *args, **kw):
        if sr.is_cuda:
            plain_on_card.append(tuple(sr.shape))
        return plain(sr, *args, **kw)

    models = {}
    for dt in dtypes:
        model = build_model(bench_opt(dt), device=device)
        state = model.init_state(seed=0)
        stored, cfg = dense_route(BENCH_B, BENCH_GT, BENCH_GT, model.ssl_setting.ssg)
        before = {name: [p.detach().clone() for p in net.parameters()]
                  for name, net in (("g", state.net_g), ("d", state.net_d),
                                    ("ema", state.net_g_ema))}
        models[dt] = [model, state, stored, k1_mode_name(cfg), before]
    for turn, dt in enumerate(BENCH_TURNS):
        model, state, stored, mode, _ = models[dt]
        torch.cuda.reset_peak_memory_stats()
        ssg_cuda.launches, ssg_cuda.launches_by_mode, ssg_cuda.stream_launches = 0, {}, 0
        ssg_cuda.ssl_loss_sums_reference = counted_plain
        try:
            state, logs = model.train_step(state, batch)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BENCH_STEPS):
                state, logs = model.train_step(state, batch)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / BENCH_STEPS
        finally:
            ssg_cuda.ssl_loss_sums_reference = plain
        models[dt][1] = state
        by_mode = {K1_MODE_NAMES[m]: n for m, n in ssg_cuda.launches_by_mode.items()}
        streamed = ssg_cuda.stream_launches
        if by_mode != {mode: BENCH_STEPS + 1} or plain_on_card or streamed != (
                BENCH_STEPS + 1 if mode.endswith("store") else 0):
            fail(f"bench {dt}: K1 launched {by_mode} and its stream kernel {streamed} times in "
                 f"{BENCH_STEPS + 1} steps, expected {mode} once a step (the stream too with "
                 f"the bf16 store); the plain forward on the card at {plain_on_card}")
        values = {k: float(logs[k]) for k in RC_LOSSES}
        if not all(np.isfinite(v) for v in values.values()):
            fail(f"bench {dt}: non-finite loss: {values}")
        launches_by[mode] = launches_by.get(mode, 0) + by_mode[mode]
        launches_by["stream_kernel"] = launches_by.get("stream_kernel", 0) + streamed
        run = {"turn": turn, "ms_per_step": 1e3 * step_s, "imgs_per_s": BENCH_B / step_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "k1_mode": mode,
               "k1_launches": by_mode[mode], "k1_stream_launches": streamed,
               "ssg_route": "stored" if stored else "batched", "losses": values}
        runs.setdefault(dt, []).append(run)
        emit({"phase": "bench", "dtype": dt, **run})
    for dt, (model, state, _, _, before) in models.items():
        for name, net in (("g", state.net_g), ("d", state.net_d), ("ema", state.net_g_ema)):
            if all(torch.equal(a, p) for a, p in zip(before[name], net.parameters())):
                fail(f"bench {dt}: {name} parameters did not change")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    ms = {dt: sum(r["ms_per_step"] for r in rs) / len(rs) for dt, rs in runs.items()}
    emit({"phase": "bench", "config": "bench.py:54-116 (its defaults; float32: its four bf16 "
                                      "knobs in float32)",
          "batch": BENCH_B, "gt_size": BENCH_GT, "steps_timed": BENCH_STEPS, "warmup_steps": 1,
          "turns": list(BENCH_TURNS), "ms_per_step": ms,
          "imgs_per_s": {dt: BENCH_B / (1e-3 * v) for dt, v in ms.items()},
          "peak_mem_gb": {dt: max(r["peak_mem_gb"] for r in rs) for dt, rs in runs.items()},
          "bf16_speedup": ms["float32"] / ms["bfloat16"],
          "bf16_vs_float32_of_scale": held, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "k1": "float32 window sums (running sums in double), csrc/ssg_loss_fwd.cu; with the "
                "bf16 store the walk, then the stream over its q stack",
          "bench_matmul_precision": "bench.py's JAX global; no counterpart: cuDNN TF32 as the "
                                    "port's training runs",
          "card": card() if device == "cuda" else None})
    return launches_by, runs


def smooth_picture(h: int, w: int, gen, device: str):
    """A seeded (3, h, w) RGB image on uint8 levels, made on ``device``:
    smooth colour fields with three sharp-edged blocks and light noise."""
    import torch
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None]
    f = torch.rand(3, 4, generator=gen, device=device) * 6 + 1
    img = torch.stack([0.5 + 0.25 * torch.sin(f[c, 0] * yy + f[c, 1] * xx + f[c, 2])
                       * torch.cos(f[c, 3] * xx) for c in range(3)])
    for _ in range(3):                                    # sharp-edged blocks
        y0, x0 = (torch.rand(2, generator=gen, device=device) * 0.7).tolist()
        img[:, int(y0 * h):int((y0 + 0.25) * h), int(x0 * w):int((x0 + 0.25) * w)] = \
            torch.rand(3, 1, 1, generator=gen, device=device)
    img = img + 0.02 * torch.randn(img.shape, generator=gen, device=device)
    return torch.round(img.clamp(0, 1) * 255)                           # (3, h, w), uint8 values


def cli_fixtures(root: str, device: str) -> tuple[dict, list]:
    """The CLI's data, written under ``root``: CLI_TRAIN seeded GT images of
    CLI_GT^2 (smooth fields with sharp-edged blocks) as PNG through
    ``utils/png.py``; their LQ made on the card (antialiased bicubic down by
    SCALE, rounded to uint8); ``.mat`` masks from ``edge_mask_torch`` on the
    card (threshold 20); and CLI_VAL pairs, one of whose LQ sides is not a
    multiple of 16.  Returns the folders by name and the count of the GT
    files' rows by PNG filter type (Average and Paeth rows decode pixel by
    pixel without cv2)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from scipy.io import savemat
    from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
    from ssl_tpu_torch.utils.png import encode_png, row_filters

    d = {k: os.path.join(root, k) for k in ("gt", "lq", "mask", "vgt", "vlq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(0)

    def picture(h, w):
        return smooth_picture(h, w, gen, device)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR PNG
        data = encode_png(img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1])
        with open(path, "wb") as f:
            f.write(data)
        return data

    def down(gt_u8):
        lq = F.interpolate(gt_u8[None] / 255, scale_factor=1 / SCALE, mode="bicubic",
                           antialias=True, align_corners=False)[0]
        return torch.round(lq.clamp(0, 1) * 255)

    filters = np.zeros(5, np.int64)
    for i in range(CLI_TRAIN):
        gt = picture(CLI_GT, CLI_GT)
        filters += np.bincount(row_filters(save(gt, os.path.join(d["gt"], f"{i:04d}.png"))),
                               minlength=5)
        save(down(gt), os.path.join(d["lq"], f"{i:04d}.png"))
        mask = edge_mask_torch(gt[None] / 255, 20.0)[0, 0]
        savemat(os.path.join(d["mask"], f"{i:04d}.mat"),
                {"mat": mask.cpu().numpy().astype(np.float64)})
    for i, (h, w) in enumerate(CLI_VAL):
        gt = picture(h, w)
        save(gt, os.path.join(d["vgt"], f"val{i}.png"))
        save(down(gt), os.path.join(d["vlq"], f"val{i}.png"))
    return d, filters.tolist()


def cli_opt(d: dict, batch: int) -> dict:
    """options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml's values
    (``shipped_opt``) with the data of ``cli_fixtures`` and this phase's
    counts: CLI_ITERS iterations, a log line at each, validation and a
    checkpoint at the last, no tensorboard."""
    opt = shipped_opt(batch)
    opt.update({"tile_process": False, "tile_size": 800, "tile_pad": 32})
    opt["datasets"] = {
        "train": {"name": "DF2K_OST", "type": "PairedImageMaskDataset",
                  "dataroot_gt": d["gt"], "dataroot_lq": d["lq"], "dataroot_gt_mask": d["mask"],
                  "filename_tmpl": "{}", "io_backend": {"type": "disk"}, "gt_size": MAIN_GT,
                  "use_hflip": True, "use_rot": True, "num_worker_per_gpu": CLI_WORKERS,
                  "batch_size_per_gpu": batch, "dataset_enlarge_ratio": CLI_ENLARGE},
        "val": {"name": "DIV2K100", "type": "PairedImageDataset", "dataroot_gt": d["vgt"],
                "dataroot_lq": d["vlq"], "io_backend": {"type": "disk"}}}
    opt["path"]["resume_state"] = None
    opt["train"]["total_iter"] = CLI_ITERS
    opt["val"] = {"val_freq": CLI_ITERS, "save_img": None, "metrics": CLI_METRICS}
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": CLI_ITERS, "use_tb_logger": False}
    return opt


class Spy:
    """Wraps methods of a class to record their results and their time (each
    call ends in a synchronise on the card); ``restore`` puts them back."""

    def __init__(self, cls, names, device):
        import torch
        self.cls, self.calls, self.saved = cls, {n: [] for n in names}, {}
        for name in names:
            orig = getattr(cls, name)
            self.saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
                self.calls[_name].append((time.perf_counter() - t0, out))
                return out
            setattr(cls, name, wrapped)

    def restore(self):
        for name, orig in self.saved.items():
            setattr(self.cls, name, orig)


def per_iter_ms(logged, key):
    """Mean ms per iteration of a logger timer over iterations 2.. of a run:
    the AvgTimer's running means at the first and last log line, unfolded."""
    first, last = logged[0], logged[-1]
    n = last["iter"] - first["iter"]
    k0, k1 = first["iter"] - first["start"], last["iter"] - first["start"]
    return 1e3 * (k1 * last[key] - k0 * first[key]) / n


class without_cv2:
    """Hide ``cv2`` while the block runs (the loader's worker processes, forked
    inside it, inherit that): images then decode through
    ``ssl_tpu_torch/utils/png.py``, as on a machine without ``cv2``."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2", False)
        sys.modules["cv2"] = None

    def __exit__(self, *exc):
        if self.saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = self.saved


class metric_seconds:
    """Seconds of validation spent in each metric (``models/sr_model.py``'s
    ``calculate_metric``, by ``type``) while the block runs; the metrics
    return floats, so each call ends with the card's work done."""

    def __enter__(self) -> dict:
        from ssl_tpu_torch.models import sr_model
        self.module, self.saved, self.seconds = sr_model, sr_model.calculate_metric, {}

        def timed(data, opt):
            t0 = time.perf_counter()
            out = self.saved(data, opt)
            self.seconds[opt["type"]] = self.seconds.get(opt["type"], 0.0) + \
                time.perf_counter() - t0
            return out

        sr_model.calculate_metric = timed
        return self.seconds

    def __exit__(self, *exc):
        self.module.calculate_metric = self.saved


def lpips_dists_s(tests: dict) -> float:
    """Seconds the test CLI runs of ``tests`` spent in LPIPS and DISTS."""
    return sum(t["metric_s"].get(k, 0.0) for t in tests.values()
               for k in ("calculate_lpips", "calculate_dists"))


def test_record(out: dict, seconds: float, metric_s: dict, n_images: int | None = None) -> dict:
    """A test CLI run's metrics and time: ``seconds``, or ``ms_per_image``
    over ``n_images``, each also net of the seconds LPIPS and DISTS took, the
    figure comparable with runs that scored PSNR and SSIM only."""
    net = seconds - lpips_dists_s({"run": {"metric_s": metric_s}})
    if n_images is None:
        return dict(out, seconds=seconds, seconds_net_of_lpips_dists=net, metric_s=metric_s)
    return dict(out, ms_per_image=1e3 * seconds / n_images,
                ms_per_image_net_of_lpips_dists=1e3 * net / n_images, metric_s=metric_s)


def metric_weights(root: str) -> dict:
    """Seeded checkpoints at full width in each metric's official layout
    (``tests/torch_metric_cases.py``) under ``root``, and the env vars that
    point the metrics at them (the test CLI runs of the later phases read
    LPIPS's and DISTS's); returns them by env var."""
    from torch_metric_cases import (RN50, write_clip_rn50, write_dists, write_fid_inception,
                                    write_lpips, write_merges)
    lpips, alexnet = write_lpips(root, seed=1)
    dists, vgg16 = write_dists(root, seed=2)
    paths = {"LPIPS_ALEX_PTH": lpips, "ALEXNET_PTH": alexnet, "DISTS_PTH": dists,
             "VGG16_PTH": vgg16,
             "FID_INCEPTION_PTH": write_fid_inception(os.path.join(root, "pt_inception.pth")),
             "CLIP_RN50_PTH": write_clip_rn50(os.path.join(root, "rn50.pt"), seed=3, **RN50),
             "CLIP_BPE_PATH": write_merges(os.path.join(root, "merges.txt"))}
    os.environ.update(paths)
    return paths


def metric_readings(device: str, exact: bool) -> dict:
    """Each deep metric float32 on ``device`` against the same module in
    float64 on the CPU, on a METRIC_HOLD^2 picture and its noisy copy, inside
    ``exact_float32`` (``exact``) or with cuDNN's and cuBLAS's TF32 on (the
    control); the error of each reading by METRIC_BOUNDS' key: LPIPS
    relative, DISTS and the CLIP-IQA score absolute, FID's pool3 features and
    the CLIP towers' features in relative L2."""
    import contextlib
    import copy

    import torch
    from ssl_tpu_torch.metrics import clipiqa, dists_metric, fid, lpips_metric
    from ssl_tpu_torch.metrics.metric_util import exact_float32, image_tensor
    from torch_metric_cases import distorted, picture

    def f64(model):
        return copy.deepcopy(model).cpu().double()

    a = picture(METRIC_HOLD, METRIC_HOLD, 0)
    b = distorted(a, 1)
    out, finite = {}, True
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad(), (exact_float32() if exact else contextlib.nullcontext()):
            for name, load, path_var in (("lpips", lpips_metric.lpips_model, "LPIPS_ALEX_PTH"),
                                         ("dists", dists_metric.dists_model, "DISTS_PTH")):
                model = load(os.environ[path_var], device)
                xs = [image_tensor(v, 4, device) for v in (b, a)]
                if name == "lpips":                          # LPIPS takes [-1, 1]
                    xs = [x * 2 - 1 for x in xs]
                got = float(model(*xs)[0])
                ref = float(f64(model)(*(x.cpu().double() for x in xs))[0])
                out[name] = abs(got - ref) / (abs(ref) if name == "lpips" else 1.0)
                out[f"{name}_card"], out[f"{name}_float64"] = got, ref

            model = fid.load_inception(device=device)
            x = torch.stack([image_tensor(v, 0, device)[0] for v in (a, b)])
            got = model(x)
            out["fid_pool3"] = rel_l2(got.cpu(), f64(model)(x.cpu().double()))
            finite &= bool(torch.isfinite(got).all())

            visual, text, logit_scale = clipiqa._load_clip(os.environ["CLIP_RN50_PTH"],
                                                           torch.device(device))
            tokens = torch.as_tensor(clipiqa.prompt_token_ids(), dtype=torch.long)
            xn = (b.astype("float32") / 255.0 - clipiqa._CLIP_MEAN) / clipiqa._CLIP_STD
            x = torch.from_numpy(xn.transpose(2, 0, 1).copy())[None]
            feats, tfeats = visual(x.to(device)), text(tokens.to(device))
            feats64, tfeats64 = f64(visual)(x.double()), f64(text)(tokens)
            out["clip_visual"] = rel_l2(feats.cpu(), feats64)
            out["clip_text"] = rel_l2(tfeats.cpu(), tfeats64)
            got = clipiqa.clipiqa_score(feats[0].cpu().numpy(), tfeats.cpu().numpy(), logit_scale)
            ref = clipiqa.clipiqa_score(feats64[0].numpy(), tfeats64.numpy(), logit_scale)
            out["clipiqa"] = abs(got - ref)
            out["clipiqa_card"], out["clipiqa_float64"] = got, ref
            out["prompt_tokens"] = list(tokens.shape)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    if not finite:
        fail("metrics: FID pool3 features not finite")
    return out


def metric_holds(device: str) -> dict:
    """The two refusals of a checkpoint without its backbone; each deep
    metric held against float64 (``metric_readings``) inside
    ``exact_float32`` with TF32 switched on around it, as the steps run:
    each error within its METRIC_BOUNDS bound, and on the card the control
    without ``exact_float32`` beyond it, so that the holds show the scores
    are computed without TF32."""
    from ssl_tpu_torch.metrics import dists_metric, lpips_metric

    refused = {}
    for name, load, path_var, backbone_var in (
            ("lpips", lpips_metric.lpips_model, "LPIPS_ALEX_PTH", "ALEXNET_PTH"),
            ("dists", dists_metric.dists_model, "DISTS_PTH", "VGG16_PTH")):
        saved = os.environ.pop(backbone_var)
        try:
            load(os.environ[path_var], device)
        except ValueError as e:
            refused[name] = str(e)[:60]
        else:
            fail(f"metrics: a {name} checkpoint without {backbone_var} was not refused")
        finally:
            os.environ[backbone_var] = saved

    sound = metric_readings(device, exact=True)
    control = metric_readings(device, exact=False) if device == "cuda" else None
    holds = {}
    for key, bound in METRIC_BOUNDS.items():
        if not sound[key] <= bound:
            fail(f"metrics: {key} off float64 by {sound[key]}, bound {bound}")
        if control is not None and not control[key] > bound:
            fail(f"metrics: {key} with TF32 on off float64 by {control[key]}, within the "
                 f"bound {bound}: the hold cannot tell TF32 from float32")
        holds[key] = {"err": sound[key], "bound": bound,
                      "control_tf32_err": None if control is None else control[key]}
    return {"refused": refused, "holds": holds,
            "values": {k: v for k, v in sound.items() if k not in METRIC_BOUNDS}}


def phase_metrics(device: str = "cuda"):
    """The metric suite on the card: each deep metric (LPIPS, DISTS, FID's
    InceptionV3, CLIP-IQA's RN50 towers) held against its float64 CPU run
    (``metric_holds``), a checkpoint without its backbone refused; then each
    metric's entry function timed per image at METRIC_SIZES beside its nets
    alone on device tensors (NIQE on the host at 512^2), FID over a folder of PNGs at batch METRIC_FID_BATCH
    through the FID CLI's ``folder_features``, and the peak device memory.
    Expects ``metric_weights`` to have set the env vars."""
    import tempfile

    import numpy as np
    import torch
    from ssl_tpu_torch.metrics import clipiqa, dists_metric, fid, lpips_metric, niqe
    from ssl_tpu_torch.metrics.metric_util import exact_float32, image_tensor
    from ssl_tpu_torch.scripts.metrics.calculate_fid_folder import folder_features
    from ssl_tpu_torch.utils.img_util import imwrite
    from torch_metric_cases import RN50, distorted, picture

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    held = metric_holds(device)

    def per_image_ms(fn, *args):
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(METRIC_ITERS):
            fn(*args)
        return 1e3 * (time.perf_counter() - t0) / METRIC_ITERS

    lpips = lpips_metric.lpips_model(os.environ["LPIPS_ALEX_PTH"], device)
    dists = dists_metric.dists_model(os.environ["DISTS_PTH"], device)
    visual, text, _ = clipiqa._load_clip(os.environ["CLIP_RN50_PTH"], torch.device(device))
    tokens = torch.as_tensor(clipiqa.prompt_token_ids(), dtype=torch.long, device=device)
    times = {}
    for h, w in METRIC_SIZES:
        a = picture(h, w, 2)
        b = distorted(a, 3)
        xa, xb = (image_tensor(v, 4, device) for v in (a, b))
        with torch.no_grad(), exact_float32():
            # each net alone on tensors already on the device (CUDA events);
            # the entry function adds the host's conversion, the copy, the read
            nets = {"lpips_net_ms": time_ms(lambda: lpips(xb * 2 - 1, xa * 2 - 1), METRIC_ITERS),
                    "dists_net_ms": time_ms(lambda: dists(xb, xa), METRIC_ITERS),
                    "clip_visual_ms": time_ms(lambda: visual(xb), METRIC_ITERS),
                    "clip_text_ms": time_ms(lambda: text(tokens), METRIC_ITERS)} \
                if device == "cuda" else {}
        times[f"{h}x{w}"] = {
            "lpips_ms": per_image_ms(lambda: lpips_metric.calculate_lpips(b, a, 4, device=device)),
            "dists_ms": per_image_ms(lambda: dists_metric.calculate_dists(b, a, 4, device=device)),
            "clipiqa_ms": per_image_ms(lambda: clipiqa.calculate_clipiqa(b, device=device)),
            **nets}
    a = picture(512, 512, 4)
    t0 = time.perf_counter()
    niqe_score = niqe.calculate_niqe(a, crop_border=4)
    niqe_ms = 1e3 * (time.perf_counter() - t0)
    if not np.isfinite(niqe_score):
        fail(f"metrics: NIQE {niqe_score}")

    with tempfile.TemporaryDirectory() as root:
        for i in range(METRIC_FID_IMAGES):
            imwrite(distorted(picture(512, 512, 10 + i), i)[..., ::-1],
                    os.path.join(root, f"im{i:02d}.png"))
        model = fid.load_inception(device=device)
        folder_features(root, model, METRIC_FID_BATCH, limit=METRIC_FID_BATCH)   # warm-up
        t0 = time.perf_counter()
        feats = folder_features(root, model, METRIC_FID_BATCH)
        fid_folder_s = time.perf_counter() - t0
    if feats.shape != (METRIC_FID_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"metrics: FID features {feats.shape}")
    t0 = time.perf_counter()
    mu, sigma = fid.stats_from_features(feats)
    frechet = fid.calculate_fid_from_stats(mu, sigma, mu + 0.01, sigma)
    frechet_s = time.perf_counter() - t0
    result = {
        "phase": "metrics", "device": device, "tf32": False, **held,
        "weights": "seeded, official layouts (tests/torch_metric_cases.py)", "clip_rn50": RN50,
        "per_image": times, "niqe_host_ms_512": niqe_ms, "niqe_512": niqe_score,
        "fid_folder": {"images": METRIC_FID_IMAGES, "size": 512, "batch": METRIC_FID_BATCH,
                       "decoder": decoder(), "seconds": fid_folder_s,
                       "ms_per_image": 1e3 * fid_folder_s / METRIC_FID_IMAGES,
                       "frechet_host_s": frechet_s, "fid_shifted_mean": frechet},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else None,
        "card": card() if device == "cuda" else None}
    emit(result)
    return result


def decoder() -> str:
    """What ``utils/img_util.py`` decodes with here."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "ssl_tpu_torch/utils/png.py"
    return "cv2"


def loader_alone_ms(opt: dict, device: str) -> float:
    """ms per batch of the train loader alone (CLI_WORKERS processes, pinned
    batches, no step), over the batches after the first of one epoch."""
    import gc
    from ssl_tpu_torch.data import EnlargedSampler, build_dataloader, build_dataset
    dopt = dict(opt["datasets"]["train"], phase="train", scale=SCALE)
    dataset = build_dataset(dopt)
    loader = build_dataloader(dataset, dopt, EnlargedSampler(len(dataset), 1, 0, CLI_ENLARGE),
                              seed=opt["manual_seed"], device=device)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    ms = 1e3 * (time.perf_counter() - t0) / n
    del it, loader
    gc.collect()
    return ms


def state_tensors(state) -> dict:
    """Every tensor of a training state by name: the nets (a recipe's
    further nets and the modules of ``extra`` too) and both optimizers'
    moments."""
    import torch
    nets = {"net_g": state.net_g, "net_g_ema": state.net_g_ema, "net_d": state.net_d,
            **state.nets, **{f"extra.{k}": v for k, v in (state.extra or {}).items()
                             if isinstance(v, torch.nn.Module)}}
    out = {f"{n}.{k}": v for n, net in nets.items() if net is not None
           for k, v in net.state_dict().items()}
    for name in ("opt_g", "opt_d"):
        for pid, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{pid}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    return out


def run_train_cli(root: str, args: list, device: str, spies=()):
    """One run of the train CLI's pipeline in this process; returns its
    state, the logged lines (each with the logger's start iteration), the K1
    launches and the wall seconds.  ``spies`` are restored after it."""
    import gc
    import torch
    import ssl_tpu_torch.train as train_cli
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.utils import logger as logger_mod

    logged = []
    log_call = logger_mod.MessageLogger.__call__

    def record(self, log_vars):
        logged.append(dict(log_vars, start=self.start_iter))
        return log_call(self, log_vars)
    logger_mod.MessageLogger.__call__ = record
    try:
        ssg_cuda.launches = 0
        t0 = time.perf_counter()
        state = train_cli.train_pipeline(root, args)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ssg_cuda.launches
    finally:
        logger_mod.MessageLogger.__call__ = log_call
        for spy in spies:
            spy.restore()
    gc.collect()                                          # the loader's workers end here
    return state, logged, launches, wall


def phase_cli(device: str = "cuda"):
    """The ESRGAN-SSL train and test CLIs (``ssl_tpu_torch.train`` /
    ``ssl_tpu_torch.test``) at full width on the ``cli_fixtures`` data, through
    their pipelines in this process: CLI_ITERS iterations with validation and
    checkpoints; the training state reloaded into a fresh model and held bit for
    bit; ``--auto_resume`` to CLI_RESUME_ITERS; then the test CLI on the last
    ``net_g`` (``params_ema``), whole and with ``tile_process``.  K1 must launch
    once per iteration."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import BaseModel
    from ssl_tpu_torch.models.sr_model import SRModel

    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as root:
        t0 = time.perf_counter()
        d, gt_filters = cli_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        opt = cli_opt(d, MAIN_B)
        opt_path = os.path.join(root, "train_cli.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        dev = ["--device", device] if device != "cuda" else []

        def run(args):
            """One train CLI run; returns its state, logged lines, K1 launches,
            validation and checkpoint calls and wall seconds."""
            spies = (Spy(SRModel, ["validation"], device),
                     Spy(BaseModel, ["save_networks", "save_training_state"], device))
            state, logged, launches, wall = run_train_cli(root, ["-opt", opt_path] + dev + args,
                                                          device, spies)
            return state, logged, launches, {**spies[0].calls, **spies[1].calls}, wall

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with without_cv2():                               # the PNG path a cv2-less card takes
            decoders = {"train": decoder()}
            state, logged, launches, calls, wall = run([])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        exp = os.path.join(root, "experiments", opt["name"])
        if launches != CLI_ITERS:
            fail(f"cli: K1 launched {launches} times in {CLI_ITERS} iterations")
        if [x["iter"] for x in logged] != list(range(1, CLI_ITERS + 1)):
            fail(f"cli: logged iterations {[x['iter'] for x in logged]}")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        for x in logged:
            bad = {k: x.get(k) for k in loss_keys if not np.isfinite(x.get(k, np.nan))}
            if bad:
                fail(f"cli: iteration {x['iter']}: losses missing or not finite: {bad}")
        val = [out for _, out in calls["validation"]]
        if len(val) != 1 or set(val[0]) != set(CLI_METRICS) or \
                not all(np.isfinite(v) for v in val[0].values()):
            fail(f"cli: validation results {val}")
        for f in (f"models/net_g_{CLI_ITERS}.pth", f"models/net_d_{CLI_ITERS}.pth",
                  f"training_states/{CLI_ITERS}.state"):
            if not os.path.isfile(os.path.join(exp, f)):
                fail(f"cli: {f} was not written")

        # the training state, reloaded into a fresh model, bit for bit
        fresh = build_model(dict(opt, is_train=True), device=device)
        reloaded, it = fresh.load_training_state(fresh.init_state(seed=1),
                                                 os.path.join(exp, "training_states"), CLI_ITERS)
        want, got = state_tensors(state), state_tensors(reloaded)
        n_tensors = len(want)
        for k, v in want.items():
            if k not in got or not torch.equal(got[k], v):
                fail(f"cli: reloaded {k} differs from the saved state")
        if it != CLI_ITERS or reloaded.step != state.step:
            fail(f"cli: reloaded iteration {it}, step {reloaded.step} vs {state.step}")
        del fresh, reloaded, state
        gc.collect()

        decoders["resumed"] = decoder()
        resumed, logged_r, launches_r, _, wall_r = run(
            ["--auto_resume", "--force_yml", f"train:total_iter={CLI_RESUME_ITERS}"])
        if [x["iter"] for x in logged_r] != list(range(CLI_ITERS + 1, CLI_RESUME_ITERS + 1)):
            fail(f"cli: the resumed run logged iterations {[x['iter'] for x in logged_r]}")
        if launches_r != CLI_RESUME_ITERS - CLI_ITERS or resumed.step != CLI_RESUME_ITERS:
            fail(f"cli: the resumed run launched K1 {launches_r} times, ended at step "
                 f"{resumed.step}")
        del resumed
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        loader_ms = {decoders["resumed"]: loader_alone_ms(opt, device)}
        with without_cv2():
            loader_ms[decoder()] = loader_alone_ms(opt, device)

        test_opt = {"name": "test_ESRGANSSL_bicubic_x4", "model_type": "ESRGANSSLModel",
                    "scale": SCALE, "num_devices": 1, "manual_seed": 0,
                    "datasets": {"test_1": dict(opt["datasets"]["val"], name="val_pairs")},
                    "network_g": opt["network_g"],
                    "path": {"pretrain_network_g": os.path.join(
                        exp, "models", f"net_g_{CLI_RESUME_ITERS}.pth"),
                        "param_key_g": "params_ema"},
                    "val": {"save_img": True, "metrics": TEST_METRICS}}
        test_path = os.path.join(root, "test_cli.json")
        with open(test_path, "w") as f:
            json.dump(test_opt, f)
        tests = {}
        for label, extra in (("whole", []), ("tiled", [
                "--force_yml", "name=test_tiled", "tile_process=true",
                f"tile_size={CLI_TILE[0]}", f"tile_pad={CLI_TILE[1]}"])):
            t0 = time.perf_counter()
            with metric_seconds() as metric_s:
                out = test_cli.test_pipeline(root, ["-opt", test_path] + dev + extra)["val_pairs"]
            if device == "cuda":
                torch.cuda.synchronize()
            tests[label] = test_record(out, time.perf_counter() - t0, metric_s)
            if set(out) != set(TEST_METRICS) or not all(np.isfinite(v) for v in out.values()):
                fail(f"cli: test CLI ({label}) metrics {out}")
        saved_imgs = sorted(os.listdir(os.path.join(root, "results", "test_tiled",
                                                    "visualization", "val_pairs")))
        if len(saved_imgs) != len(CLI_VAL):
            fail(f"cli: the tiled test run saved {saved_imgs}")

    result = {
        "phase": "cli", "train_images": CLI_TRAIN, "gt_image": CLI_GT, "batch": MAIN_B,
        "gt_size": MAIN_GT, "workers": CLI_WORKERS, "fixtures_s": fixtures_s,
        "decoders": decoders, "gt_png_rows_by_filter": gt_filters,
        "iterations": CLI_ITERS, "iterations_timed": CLI_ITERS - 1,
        "ms_per_iter": per_iter_ms(logged, "time"),
        "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
        "first_iter_ms": 1e3 * logged[0]["time"], "first_data_wait_ms": 1e3 * logged[0]["data_time"],
        "resumed_ms_per_iter": per_iter_ms(logged_r, "time"),
        "resumed_data_wait_ms_per_iter": per_iter_ms(logged_r, "data_time"),
        "loader_alone_ms_per_batch": loader_ms,
        "wall_s": wall, "resumed_wall_s": wall_r, "peak_mem_gb": peak_gb,
        "k1_launches": {"train": launches, "resumed": launches_r},
        "losses_last_iter": {k: logged[-1][k] for k in loss_keys},
        "validation": val[0], "validation_ms": 1e3 * calls["validation"][0][0],
        "save_networks_ms": [1e3 * t for t, _ in calls["save_networks"]],
        "save_training_state_ms": [1e3 * t for t, _ in calls["save_training_state"]],
        "reloaded_tensors_bit_for_bit": n_tensors, "resumed_from": CLI_ITERS,
        "test": tests, "test_lpips_dists_s": lpips_dists_s(tests), "tile": list(CLI_TILE),
        "card": card() if device == "cuda" else None}
    emit(result)
    return launches + launches_r


def realesrgan_opt(d: dict) -> dict:
    """options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml's values (a
    dict: the card's machine may lack yaml) with the data of
    ``realesrgan_fixtures`` and this phase's cuts (``queue_size`` RE_QUEUE,
    ``dataset_enlarge_ratio`` RE_ENLARGE, RE_ITERS iterations, a log line at
    each, no tensorboard)."""
    kernels = ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
               "plateau_aniso"]
    probs = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
    return {
        "name": "RealESRGANSSL_x4", "model_type": "RealESRGANSSLModel", "scale": SCALE,
        "num_devices": 1, "manual_seed": 0, "degradation_order": "two", "queue_size": RE_QUEUE,
        "degradation_device": True,
        "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.15, 1.5], "gaussian_noise_prob": 0.5,
        "noise_range": [1, 30], "poisson_scale_range": [0.05, 3], "gray_noise_prob": 0.4,
        "jpeg_range": [30, 95], "second_blur_prob": 0.8, "resize_prob2": [0.3, 0.4, 0.3],
        "resize_range2": [0.3, 1.2], "gaussian_noise_prob2": 0.5, "noise_range2": [1, 25],
        "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.4, "jpeg_range2": [30, 95],
        "datasets": {"train": {
            "name": "DF2K_OST_mask", "type": "MyRealESRGANImageMaskDataset",
            "dataroot_gt": d["gt"], "dataroot_gt_mask": d["mask"], "crop_pre": RE_CROP,
            "blur_kernel_size": 21, "kernel_list": kernels, "kernel_prob": probs,
            "sinc_prob": 0.1, "blur_sigma": [0.2, 3], "betag_range": [0.5, 4],
            "betap_range": [1, 2], "blur_kernel_size2": 21, "kernel_list2": kernels,
            "kernel_prob2": probs, "sinc_prob2": 0.1, "blur_sigma2": [0.2, 1.5],
            "betag_range2": [0.5, 4], "betap_range2": [1, 2], "final_sinc_prob": 0.8,
            "gt_size": 256, "use_hflip": True, "use_rot": True,
            "num_worker_per_gpu": RE_WORKERS, "batch_size_per_gpu": RE_B,
            "dataset_enlarge_ratio": RE_ENLARGE}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 64,
                      "num_block": 23, "num_grow_ch": 32},
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 64,
                      "skip_connection": True},
        "path": {"pretrain_network_g": None, "param_key_g": "params_ema", "resume_state": None},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 25,
                        "sigma": 0.004, "kernel_size_window": 9, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "total_iter": RE_ITERS, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "perceptual_opt": {"type": "PerceptualLoss",
                               "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                                                 "conv4_4": 1, "conv5_4": 1},
                               "vgg_type": "vgg19", "use_input_norm": True,
                               "perceptual_weight": 1.0, "style_weight": 0, "range_norm": False,
                               "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 1e-1},
            "net_d_iters": 1, "net_d_init_iters": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 5000, "use_tb_logger": False},
    }


def realesrgan_fixtures(root: str, device: str) -> tuple[dict, float]:
    """RE_TRAIN GT PNGs of RE_GT_IMG^2 made on the card (``smooth_picture``)
    and written with cv2 where it imports (else ``utils/png.py``); their
    ``.mat`` masks from the port's ``generate_mask`` entry point at threshold
    20; and a BlindLR-style test set: RE_TEST_GT GT images, each with one LQ
    per variant of RE_VARIANTS made on the card (antialiased bicubic down by
    SCALE; area down by SCALE plus Gaussian noise of sigma 5 levels), rounded
    to uint8.  Returns the folders and the masks' share of edge pixels."""
    import numpy as np
    import torch
    from ssl_tpu_torch.utils.img_util import imwrite

    d = {k: os.path.join(root, k) for k in ("gt", "test_gt", "test_lq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(1)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR file
        imwrite(np.ascontiguousarray(img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]),
                path)

    for i in range(RE_TRAIN):
        save(smooth_picture(RE_GT_IMG, RE_GT_IMG, gen, device),
             os.path.join(d["gt"], f"{i:04d}.png"))
    d["mask"], share = generate_masks(d["gt"], os.path.join(root, "masks"))
    blind_test_set(d, gen, device, save)
    return d, share


def generate_masks(gt_dir: str, out_dir: str) -> tuple[str, float]:
    """``.mat`` masks of the images in ``gt_dir`` through the port's
    ``generate_mask`` entry point (threshold 20); returns their folder and
    their mean share of edge pixels."""
    import numpy as np
    from ssl_tpu_torch.scripts import generate_mask
    mask_dir = generate_mask.main(["--input", gt_dir, "--output", out_dir, "--threshold", "20"])
    with open(os.path.join(os.path.dirname(mask_dir), "edge_pixel_stats.txt")) as f:
        shares = [float(line.split()[2]) for line in f if line.strip()]
    return mask_dir, float(np.mean(shares))


def blind_test_set(d: dict, gen, device: str, save) -> None:
    """A BlindLR-style test set under ``d["test_gt"]`` / ``d["test_lq"]``:
    RE_TEST_GT GT images of RE_TEST_SIZE (``smooth_picture`` from ``gen``),
    each with one LQ per variant of RE_VARIANTS made on ``device``
    (antialiased bicubic down by SCALE; area down by SCALE plus Gaussian noise
    of sigma 5 levels), rounded to uint8, written by ``save``."""
    import torch
    import torch.nn.functional as F
    h, w = RE_TEST_SIZE
    for i in range(RE_TEST_GT):
        gt = smooth_picture(h, w, gen, device)
        save(gt, os.path.join(d["test_gt"], f"t{i}.png"))
        x = gt[None] / 255
        lqs = {"bicubic": F.interpolate(x, scale_factor=1 / SCALE, mode="bicubic",
                                        antialias=True, align_corners=False),
               "area_noise": F.interpolate(x, scale_factor=1 / SCALE, mode="area")
               + 5 / 255 * torch.randn((1, 3, h // SCALE, w // SCALE), generator=gen,
                                       device=device)}
        for variant in RE_VARIANTS:
            os.makedirs(os.path.join(d["test_lq"], variant), exist_ok=True)
            save(torch.round(lqs[variant][0].clamp(0, 1) * 255),
                 os.path.join(d["test_lq"], variant, f"t{i}.png"))


def draws_to(draws, device):
    """A ``DegradeDraws`` with its tensors on ``device``."""
    import torch

    def move(stage):
        return stage._replace(**{k: v.to(device) for k, v in stage._asdict().items()
                                 if torch.is_tensor(v)})
    return draws._replace(stage1=move(draws.stage1), stage2=move(draws.stage2),
                          jpeg1=draws.jpeg1.to(device), jpeg2=draws.jpeg2.to(device))


def poisson_icdf(rate, u):
    """Poisson(rate) samples by inversion of given uniforms ``u`` (float64):
    the least k with P(X <= k) = Q(k + 1, rate) >= u, by bisection.  Each
    element depends on its own rate and uniform only, so two devices give
    the same samples from the same uniforms (a sampler that consumes a
    generator element by element would shift every later sample where one
    rate differs in its last bit)."""
    import torch
    lam = rate.double()
    lo = torch.zeros_like(lam)
    hi = torch.ceil(lam + 12 * lam.sqrt() + 12)
    while bool((lo < hi).any()):
        mid = torch.floor((lo + hi) / 2)
        below = torch.special.gammaincc(mid + 1, lam) < u
        lo, hi = torch.where(below, mid + 1, lo), torch.where(below, hi, mid)
    return lo.to(rate.dtype)


def degradation_hold(batch: dict, cfg) -> dict:
    """One fixed ``DegradeDraws`` through ``degrade_two_stage`` on the card
    and on the CPU with TF32 off: at most one uint8 level apart, on at most
    RE_TIE_SHARE of the values, equal elsewhere.  The Poisson samples invert
    uniforms drawn on the CPU from generators seeded by stage and kind
    (``poisson_icdf``), so both sides draw them alike from their own rates.
    Both noise families are held: the draws are made twice, with Gaussian
    and with Poisson noise forced in both stages."""
    import torch
    from ssl_tpu_torch.ops.degrade import degrade_two_stage, draw_degradation

    def poisson(rate, stage, which):
        g = torch.Generator().manual_seed(10 * stage + (which == "gray"))
        u = torch.rand(rate.shape, generator=g, dtype=torch.float64)
        return poisson_icdf(rate, u.to(rate.device))

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cpu = {k: batch[k].cpu() for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
    out = {}
    try:
        for family, p in (("gaussian", 1.0), ("poisson", 0.0)):
            fcfg = cfg._replace(gaussian_noise_prob=p, gaussian_noise_prob2=p)
            draws = draw_degradation(fcfg, RE_B, RE_CROP, torch.Generator().manual_seed(7),
                                     torch.Generator().manual_seed(8))._replace(poisson=poisson)
            on_cpu = degrade_two_stage(cpu["gt"], cpu["kernel1"], cpu["kernel2"],
                                       cpu["sinc_kernel"], fcfg, draws)
            on_card = degrade_two_stage(batch["gt"], batch["kernel1"], batch["kernel2"],
                                        batch["sinc_kernel"], fcfg,
                                        draws_to(draws, batch["gt"].device))
            levels = (torch.round(on_card.cpu() * 255) - torch.round(on_cpu * 255)).abs()
            share = float((levels > 0).float().mean())
            if float(levels.max()) > 1 or share > RE_TIE_SHARE:
                fail(f"realesrgan: the {family} degradation on the card is {float(levels.max())} "
                     f"levels from the CPU's on {share} of the values (hold: 1 level on at most "
                     f"{RE_TIE_SHARE})")
            out[family] = {"values_one_level_off": int((levels > 0).sum()), "share": share,
                           "lq_shape": list(on_card.shape),
                           "stage_buckets": [draws.stage1.bucket, draws.stage2.bucket],
                           "modes": [draws.stage1.mode, draws.stage2.mode]}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_realesrgan(device: str = "cuda"):
    """The RealESRGAN-SSL train and test CLIs at full width on the
    ``realesrgan_fixtures`` data: RE_ITERS iterations (each degrades the GT
    batch on the card, makes the USM target, passes the pool, then trains G,
    D and the EMA with K1 in the SSL loss), the training state reloaded into
    a fresh model bit for bit (pool and generators included),
    ``--auto_resume`` to RE_RESUME_ITERS, then the test CLI on the last
    ``net_g`` over the BlindLR-style set with the shipped test YAML's
    metrics (TEST_METRICS: PSNR, SSIM, LPIPS and DISTS).
    Then the degradation + USM + pool alone (CUDA events) and the degradation
    hold card against CPU.  K1 must launch once per iteration."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    import ssl_tpu_torch.train as train_cli
    from ssl_tpu_torch.data import build_dataloader, build_dataset
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.realesrganssl_model import RealESRGANSSLModel
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.degrade import degrade_two_stage
    from ssl_tpu_torch.ops.img_process import usm_sharp
    from ssl_tpu_torch.utils import logger as logger_mod

    with tempfile.TemporaryDirectory(prefix="realesrgan_smoke_") as root:
        t0 = time.perf_counter()
        d, edge_share = realesrgan_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        opt = realesrgan_opt(d)
        opt_path = os.path.join(root, "train_realesrgan.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        dev = ["--device", device] if device != "cuda" else []

        def run(args):
            """One train CLI run: its state, logged lines, K1 launches, the
            pool pointer after each step and wall seconds."""
            logged, ptrs = [], []
            log_call = logger_mod.MessageLogger.__call__
            step_call = RealESRGANSSLModel.train_step

            def record(self, log_vars):
                logged.append(dict(log_vars, start=self.start_iter))
                return log_call(self, log_vars)

            def step(self, state, batch, draws=None):
                out = step_call(self, state, batch, draws)
                ptrs.append(state.extra["queue_ptr"])
                return out
            logger_mod.MessageLogger.__call__ = record
            RealESRGANSSLModel.train_step = step
            try:
                ssg_cuda.launches = 0
                t0 = time.perf_counter()
                state = train_cli.train_pipeline(root, ["-opt", opt_path] + dev + args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ssg_cuda.launches
            finally:
                logger_mod.MessageLogger.__call__ = log_call
                del RealESRGANSSLModel.train_step             # the mixin's again
            gc.collect()                                  # the loader's workers end here
            return state, logged, launches, ptrs, wall

        torch.cuda.reset_peak_memory_stats()
        state, logged, launches, ptrs, wall = run([])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        exp = os.path.join(root, "experiments", opt["name"])
        if launches != RE_ITERS:
            fail(f"realesrgan: K1 launched {launches} times in {RE_ITERS} iterations")
        if [x["iter"] for x in logged] != list(range(1, RE_ITERS + 1)):
            fail(f"realesrgan: logged iterations {[x['iter'] for x in logged]}")
        if ptrs != [min(RE_B * (i + 1), RE_QUEUE) for i in range(RE_ITERS)] or ptrs[1] != RE_QUEUE:
            fail(f"realesrgan: the pool pointer read {ptrs} after iterations 1-{RE_ITERS}")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        for x in logged:
            bad = {k: x.get(k) for k in loss_keys if not np.isfinite(x.get(k, np.nan))}
            if bad:
                fail(f"realesrgan: iteration {x['iter']}: losses missing or not finite: {bad}")
        for f in (f"models/net_g_{RE_ITERS}.pth", f"models/net_d_{RE_ITERS}.pth",
                  f"training_states/{RE_ITERS}.state"):
            if not os.path.isfile(os.path.join(exp, f)):
                fail(f"realesrgan: {f} was not written")

        # the training state, reloaded into a fresh model, bit for bit
        fresh = build_model(dict(opt, is_train=True), device=device)
        reloaded, it = fresh.load_training_state(fresh.init_state(seed=1),
                                                 os.path.join(exp, "training_states"), RE_ITERS)
        n_tensors = 0
        for name in ("net_g", "net_g_ema", "net_d"):
            want = getattr(state, name).state_dict()
            for k, v in getattr(reloaded, name).state_dict().items():
                n_tensors += 1
                if not torch.equal(v, want[k]):
                    fail(f"realesrgan: reloaded {name}.{k} differs from the saved state")
        for name in ("opt_g", "opt_d"):
            want = getattr(state, name).state_dict()["state"]
            for pid, st in getattr(reloaded, name).state_dict()["state"].items():
                for k, v in st.items():
                    n_tensors += 1
                    if not torch.equal(v, want[pid][k]):
                        fail(f"realesrgan: reloaded {name} state {pid}.{k} differs")
        for k, v in state.extra.items():
            got = reloaded.extra[k]
            n_tensors += 1
            same = (torch.equal(got.get_state(), v.get_state())
                    if isinstance(v, torch.Generator) else
                    torch.equal(got, v) if torch.is_tensor(v) else got == v)
            if not same:
                fail(f"realesrgan: reloaded extra[{k!r}] differs from the saved state")
        if it != RE_ITERS or reloaded.step != state.step:
            fail(f"realesrgan: reloaded iteration {it}, step {reloaded.step} vs {state.step}")
        del fresh, reloaded, state
        gc.collect()
        torch.cuda.empty_cache()

        resumed, logged_r, launches_r, ptrs_r, wall_r = run(
            ["--auto_resume", "--force_yml", f"train:total_iter={RE_RESUME_ITERS}"])
        if [x["iter"] for x in logged_r] != list(range(RE_ITERS + 1, RE_RESUME_ITERS + 1)):
            fail(f"realesrgan: the resumed run logged iterations {[x['iter'] for x in logged_r]}")
        if launches_r != RE_RESUME_ITERS - RE_ITERS or resumed.step != RE_RESUME_ITERS or \
                set(ptrs_r) != {RE_QUEUE}:
            fail(f"realesrgan: the resumed run launched K1 {launches_r} times, ended at step "
                 f"{resumed.step}, pool pointer {ptrs_r}")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        test_opt = {"name": "test_RealESRGANSSL_x4", "model_type": "RealESRGANSSLModel",
                    "scale": SCALE, "num_devices": 1, "manual_seed": 0, "tile_process": False,
                    "tile_size": 800, "tile_pad": 32,
                    "datasets": {"test_1": {"name": "BlindLR", "type": "MultiLROneGTDataset",
                                            "dataroot_gt": d["test_gt"],
                                            "dataroot_lq": d["test_lq"],
                                            "io_backend": {"type": "disk"}}},
                    "network_g": opt["network_g"],
                    "path": {"pretrain_network_g": os.path.join(
                        exp, "models", f"net_g_{RE_RESUME_ITERS}.pth"),
                        "param_key_g": "params_ema"},
                    "val": {"save_img": True, "metrics": TEST_METRICS}}
        test_path = os.path.join(root, "test_realesrgan.json")
        with open(test_path, "w") as f:
            json.dump(test_opt, f)
        t0 = time.perf_counter()
        with metric_seconds() as test_metric_s:
            test_out = test_cli.test_pipeline(root, ["-opt", test_path] + dev)["BlindLR"]
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        if set(test_out) != set(TEST_METRICS) or not all(np.isfinite(v) for v in test_out.values()):
            fail(f"realesrgan: test CLI metrics {test_out}")

        # the degradation, USM and pool alone, on one loader batch
        dopt = dict(opt["datasets"]["train"], phase="train", scale=SCALE, num_worker_per_gpu=0)
        batch = next(iter(build_dataloader(build_dataset(dopt), dopt)))
        batch = {k: v.to(device) for k, v in batch.items() if torch.is_tensor(v)}
        model = build_model(dict(opt, is_train=True), device=device)
        state = model.init_state(seed=0)
        state.net_g = state.net_g_ema = state.net_d = None    # only extra is used here
        torch.cuda.empty_cache()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        front_ms = []
        for _ in range(RE_QUEUE // RE_B + 3):                 # fill, then full
            torch.cuda.synchronize()
            e0.record()
            model.degrade_batch(state, batch)
            e1.record()
            torch.cuda.synchronize()
            front_ms.append(e0.elapsed_time(e1))
        draws = model.draws(state, batch)["degrade"]
        degrade_ms = time_ms(lambda: degrade_two_stage(batch["gt"], batch["kernel1"],
                                                       batch["kernel2"], batch["sinc_kernel"],
                                                       model.degrade_cfg, draws), 5)
        usm_ms = time_ms(lambda: usm_sharp(batch["gt"]), 5)
        hold = degradation_hold(batch, model.degrade_cfg)
        del model, state, batch
        torch.cuda.empty_cache()
        host, launches_h = realesrgan_host_run(root, opt, device)

    fill = RE_QUEUE // RE_B
    result = {
        "phase": "realesrgan", "model": "RealESRGANSSLModel", "config":
            "options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml",
        "train_images": RE_TRAIN, "gt_image": RE_GT_IMG, "crop_pre": RE_CROP, "batch": RE_B,
        "lq_size": RE_CROP // SCALE, "workers": RE_WORKERS, "fixtures_s": fixtures_s,
        "mask_edge_share": edge_share, "decoder": decoder(),
        "reduced": {"queue_size": [180, RE_QUEUE], "dataset_enlarge_ratio": [1, RE_ENLARGE],
                    "total_iter": [150000, RE_RESUME_ITERS],
                    "test_sets": ["7 sets of options/test/RealESRGANSSL", "BlindLR of "
                                  f"{RE_TEST_GT} GT x {len(RE_VARIANTS)} variants"]},
        "iterations": RE_ITERS, "iterations_timed": RE_ITERS - 1,
        "ms_per_iter": per_iter_ms(logged, "time"),
        "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
        "first_iter_ms": 1e3 * logged[0]["time"], "first_data_wait_ms": 1e3 * logged[0]["data_time"],
        "resumed_ms_per_iter": per_iter_ms(logged_r, "time"),
        "resumed_data_wait_ms_per_iter": per_iter_ms(logged_r, "data_time"),
        "wall_s": wall, "resumed_wall_s": wall_r, "peak_mem_gb": peak_gb,
        "k1_launches": {"train": launches, "resumed": launches_r},
        "pool_ptr_by_iter": ptrs + ptrs_r,
        "losses_last_iter": {k: logged[-1][k] for k in loss_keys},
        "reloaded_tensors_bit_for_bit": n_tensors, "resumed_from": RE_ITERS,
        "test": test_record(test_out, test_s, test_metric_s),
        "test_lpips_dists_s": lpips_dists_s({"BlindLR": {"metric_s": test_metric_s}}),
        "degradation_usm_pool_ms": {"fill": front_ms[:fill], "full": front_ms[fill:]},
        "degradation_alone_ms": degrade_ms, "usm_alone_ms": usm_ms,
        "degradation_hold_card_vs_cpu": hold, "host_mode": host,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "card": card()}
    emit(result)
    return launches + launches_r, launches_h


def recipe_opt(recipe: str, d: dict) -> dict:
    """options/train/<recipe>/train_<recipe>_bicubic_x4.yml's values (the
    ESRGAN-SSL YAML's, ``shipped_opt``, with the recipe's own G, D and
    losses) on the ``cli_fixtures`` data, with this phase's cuts: batch
    MAIN_B, RC_WORKERS loader processes, RC_ITERS iterations with a log line
    at each and a checkpoint at the last, no validation, no tensorboard."""
    r = RECIPES[recipe]
    opt = cli_opt(d, MAIN_B)
    opt.update(json.loads(json.dumps(r["opt"])), name=f"{recipe}_x4", model_type=r["model"])
    opt["datasets"] = {"train": dict(opt["datasets"]["train"], num_worker_per_gpu=RC_WORKERS)}
    opt["train"].update(json.loads(json.dumps(r["train"])), total_iter=RC_ITERS)
    opt["val"] = {"val_freq": None, "save_img": None, "metrics": CLI_METRICS}
    opt["logger"]["save_checkpoint_freq"] = RC_ITERS
    return opt


def recipe_sr_batch(opt: dict, device: str):
    """MAIN_B training pairs of the recipe's train set (random 128^2 crops,
    flips and rotations, as the loader makes them, from a fixed seed), on
    ``device``."""
    import random

    import torch
    from ssl_tpu_torch.data import build_dataset
    random.seed(0)
    dataset = build_dataset(dict(opt["datasets"]["train"], phase="train", scale=SCALE))
    items = [dataset[i % len(dataset)] for i in range(MAIN_B)]
    return {k: torch.stack([it[k] for it in items]).to(device) for k in ("lq", "gt", "gt_mask")}


def phase_recipes(device: str = "cuda"):
    """The six bicubic GAN-SSL recipes (RECIPES) through the train and test
    CLIs at their shipped widths on the ``cli_fixtures`` data.  For each:
    RC_ITERS iterations with a checkpoint (every loss finite, the recipe's
    own losses logged, K1 once per iteration and the plain SSL forward never
    on the card), the training state reloaded into a fresh model bit for bit
    (SPSR's gradient D and RankSRGAN's Ranker included), ``--auto_resume``
    to RC_RESUME_ITERS, then the test CLI on the last ``net_g``
    (``params_ema``) whole, and for RC_TILED also in tiles.  After the SwinIR and ELAN runs K1
    is held against its plain version on their G's SR of MAIN_B training
    pairs (new generator statistics for the kernel).  Returns the K1
    launches of the runs and the holds' largest errors."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig

    plain_on_card = []
    plain = ssg_cuda.ssl_loss_sums_reference

    def counted_plain(sr, *args, **kw):
        if sr.is_cuda:
            plain_on_card.append(tuple(sr.shape))
        return plain(sr, *args, **kw)

    results, holds, launches_all = {}, {}, 0
    with tempfile.TemporaryDirectory(prefix="recipes_smoke_") as root:
        t0 = time.perf_counter()
        d, _ = cli_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        dev = ["--device", device] if device != "cuda" else []
        for recipe in RECIPES:
            opt = recipe_opt(recipe, d)
            opt_path = os.path.join(root, f"{recipe}.json")
            with open(opt_path, "w") as f:
                json.dump(opt, f)
            exp = os.path.join(root, "experiments", opt["name"])
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ssg_cuda.ssl_loss_sums_reference = counted_plain
            try:
                state, logged, launches, wall = run_train_cli(root, ["-opt", opt_path] + dev,
                                                              device)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
                files = [f"models/net_g_{RC_ITERS}.pth", f"models/net_d_{RC_ITERS}.pth",
                         f"training_states/{RC_ITERS}.state"] + \
                    [f"models/{n}_{RC_ITERS}.pth" for n in state.nets]
                missing = [f for f in files if not os.path.isfile(os.path.join(exp, f))]
                fresh = build_model(dict(opt, is_train=True), device=device)
                reloaded, it = fresh.load_training_state(
                    fresh.init_state(seed=1), os.path.join(exp, "training_states"), RC_ITERS)
                want, got = state_tensors(state), state_tensors(reloaded)
                differ = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
                step = (state.step, reloaded.step, it)
                del fresh, reloaded, state
                gc.collect()
                resumed, logged_r, launches_r, wall_r = run_train_cli(
                    root, ["-opt", opt_path] + dev +
                    ["--auto_resume", "--force_yml", f"train:total_iter={RC_RESUME_ITERS}"],
                    device)
            finally:
                ssg_cuda.ssl_loss_sums_reference = plain
            keys = RC_LOSSES + RECIPES[recipe]["losses"]
            if launches != RC_ITERS or launches_r != RC_RESUME_ITERS - RC_ITERS:
                fail(f"recipes {recipe}: K1 launched {launches} and {launches_r} times in "
                     f"{RC_ITERS} and {RC_RESUME_ITERS - RC_ITERS} iterations")
            if plain_on_card:
                fail(f"recipes {recipe}: the plain SSL forward ran on the card at "
                     f"{plain_on_card}")
            if [x["iter"] for x in logged + logged_r] != list(range(1, RC_RESUME_ITERS + 1)):
                fail(f"recipes {recipe}: logged iterations "
                     f"{[x['iter'] for x in logged + logged_r]}")
            for x in logged + logged_r:
                bad = {k: x.get(k) for k in keys if not np.isfinite(x.get(k, np.nan))}
                if bad:
                    fail(f"recipes {recipe}: iteration {x['iter']}: losses missing or not "
                         f"finite: {bad}")
            if missing or differ or step != (RC_ITERS, RC_ITERS, RC_ITERS) or \
                    resumed.step != RC_RESUME_ITERS:
                fail(f"recipes {recipe}: files missing {missing}; reloaded tensors differing "
                     f"{differ[:5]}; steps {step}, resumed to {resumed.step}")
            launches_all += launches + launches_r

            if RECIPES[recipe]["hold_k1"]:
                batch = recipe_sr_batch(opt, device)
                with torch.no_grad():
                    sr = resumed.net_g(batch["lq"])
                errs, ties = hold_k1(f"recipes {recipe} SR", sr.contiguous(), batch["gt"],
                                     batch["gt_mask"][:, 0].contiguous(),
                                     SSGConfig(search=25, window=9, sigma=0.004), 1e-4,
                                     ssg_cuda.ssg_loss_fwd_cuda, map_error_ties=True)
                if not ties["d_sr_max_abs"] > 0:
                    fail(f"recipes {recipe}: the SSL gradient of the SR K1 was held on is 0 "
                         f"(SR in [{float(sr.min())}, {float(sr.max())}])")
                holds[recipe] = {"max_abs_err": errs, "ties": ties,
                                 "sr_range": [float(sr.min()), float(sr.max())]}
                del batch, sr
            del resumed
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()

            test_opt = {"name": f"test_{recipe}", "model_type": opt["model_type"],
                        "scale": SCALE, "num_devices": 1, "manual_seed": 0,
                        "datasets": {"test_1": dict(cli_opt(d, MAIN_B)["datasets"]["val"],
                                                    name="val_pairs")},
                        "network_g": opt["network_g"],
                        "path": {"pretrain_network_g": os.path.join(
                            exp, "models", f"net_g_{RC_RESUME_ITERS}.pth"),
                            "param_key_g": "params_ema"},
                        "val": {"save_img": True, "metrics": TEST_METRICS}}
            test_path = os.path.join(root, f"test_{recipe}.json")
            with open(test_path, "w") as f:
                json.dump(test_opt, f)
            tests = {}
            runs = [("whole", [])] + [("tiled", [
                "--force_yml", f"name=test_{recipe}_tiled", "tile_process=true",
                f"tile_size={CLI_TILE[0]}", f"tile_pad={CLI_TILE[1]}"])] * (recipe in RC_TILED)
            for label, extra in runs:
                t0 = time.perf_counter()
                with metric_seconds() as metric_s:
                    out = test_cli.test_pipeline(root, ["-opt", test_path] + dev + extra)[
                        "val_pairs"]
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if set(out) != set(TEST_METRICS) or not all(np.isfinite(v) for v in out.values()):
                    fail(f"recipes {recipe}: test CLI ({label}) metrics {out}")
                tests[label] = test_record(out, seconds, metric_s, len(CLI_VAL))
            ms = per_iter_ms(logged, "time")
            results[recipe] = {
                "model": opt["model_type"], "network_g": opt["network_g"],
                "network_d": opt["network_d"]["type"],
                "ms_per_iter": ms, "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
                "first_iter_extra_ms": 1e3 * logged[0]["time"] - ms,
                "resumed_first_iter_ms": 1e3 * logged_r[-1]["time"], "peak_mem_gb": peak_gb,
                "wall_s": wall, "resumed_wall_s": wall_r,
                "k1_launches": {"train": launches, "resumed": launches_r},
                "losses_last_iter": {k: logged[-1][k] for k in keys},
                "reloaded_tensors_bit_for_bit": len(want), "test": tests,
                "test_lpips_dists_s": lpips_dists_s(tests)}
            emit({"phase": "recipes", "recipe": recipe, **results[recipe]})
    emit({"phase": "recipes", "config": {r: f"options/train/{r}/train_{r}_bicubic_x4.yml"
                                         for r in RECIPES},
          "train_images": CLI_TRAIN, "gt_image": CLI_GT, "batch": MAIN_B, "gt_size": MAIN_GT,
          "workers": RC_WORKERS, "fixtures_s": fixtures_s,
          "reduced": {"batch_size_per_gpu": [32, MAIN_B], "num_worker_per_gpu": [8, RC_WORKERS],
                      "total_iter": [400000, f"{RC_ITERS}, a save, --auto_resume to "
                                              f"{RC_RESUME_ITERS}"],
                      "dataset_enlarge_ratio": [1, CLI_ENLARGE], "validation": "none",
                      "test_sets": ["7 sets of options/test/<recipe>",
                                    f"{len(CLI_VAL)} val pairs, whole (and tiled for "
                                    f"{', '.join(RC_TILED)})"]},
          "k1_launches": launches_all, "k1_holds": holds,
          "ms_per_iter": {r: v["ms_per_iter"] for r, v in results.items()},
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "card": card() if device == "cuda" else None})
    return launches_all, holds


def kair_fixtures(root: str, device: str) -> tuple[dict, float]:
    """KR_TRAIN GT PNGs of KR_GT_IMG^2 made on the card (``smooth_picture``)
    and written through ``utils/png.py``; their ``.mat`` masks from the
    ``generate_mask`` entry point; a BlindLR-style test set
    (``blind_test_set``).  Returns the folders and the masks' edge share."""
    import numpy as np
    import torch
    from ssl_tpu_torch.utils.png import encode_png

    d = {k: os.path.join(root, k) for k in ("gt", "test_gt", "test_lq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(5)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR PNG
        with open(path, "wb") as f:
            f.write(encode_png(np.ascontiguousarray(
                img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1])))

    for i in range(KR_TRAIN):
        save(smooth_picture(KR_GT_IMG, KR_GT_IMG, gen, device),
             os.path.join(d["gt"], f"{i:04d}.png"))
    d["mask"], share = generate_masks(d["gt"], os.path.join(root, "masks"))
    blind_test_set(d, gen, device, save)
    return d, share


def kair_file(recipe: str, d: dict, root: str) -> tuple[str, dict]:
    """options/train/<recipe>/train_<recipe>_DF2K_OST_x4.json with the
    ``kair_fixtures`` data (the test section's pairs: the BlindLR set's
    bicubic LQ), the phase's batch, KR_ITERS iterations with a log line at each
    and a save at the last; written under ``root``.  Returns its path and the
    file's own batch and iterations."""
    from ssl_tpu_torch.utils.options import parse_json_options
    k = parse_json_options(os.path.join(ROOT, "options", "train", recipe,
                                        f"train_{recipe}_DF2K_OST_x4.json"))
    shipped = {"batch": k["datasets"]["train"]["dataloader_batch_size"],
               "iterations": k["train"]["iterations"]}
    k["datasets"]["train"].update(dataroot_H=d["gt"], dataroot_H_mask=d["mask"],
                                  dataloader_batch_size=KAIR[recipe]["batch"])
    k["datasets"]["test"].update(dataroot_H=d["test_gt"],
                                 dataroot_L=os.path.join(d["test_lq"], "bicubic"))
    k["train"].update(iterations=KR_ITERS, checkpoint_save=KR_ITERS, checkpoint_print=1)
    path = os.path.join(root, f"{recipe}.json")
    with open(path, "w") as f:
        json.dump(k, f)
    return path, shipped


def kair_pairs(opt: dict, n: int, device: str, seed: int = 0):
    """``n`` training pairs of the recipe's DatasetBlindSRMask (decode, crop,
    flips and the BSRGAN degradation from streams seeded with ``seed``, cv2
    hidden as in the runs) made in this process, on the card: lq, gt and the
    mask with the stride-3 lattice applied (b, h, w), as the SSL loss gives
    it to K1; and the host's ms per item."""
    import random

    import numpy as np
    import torch
    from ssl_tpu_torch.data import build_dataset
    from ssl_tpu_torch.ops.ssg import apply_mask_stride
    with without_cv2():
        dataset = build_dataset(dict(opt["datasets"]["train"], phase="train", scale=SCALE))
        dataset[0]                                        # first-call imports, out of the timing
        random.seed(seed)
        np.random.seed(seed)
        t0 = time.perf_counter()
        items = [dataset[i % len(dataset)] for i in range(n)]
        item_ms = 1e3 * (time.perf_counter() - t0) / n
    batch = {k: torch.stack([it[k] for it in items]).to(device) for k in ("lq", "gt", "gt_mask")}
    batch["mask"] = apply_mask_stride(batch.pop("gt_mask")[:, 0],
                                      opt["train"]["mask_stride"]).contiguous()
    return batch, item_ms


def phase_kair(device: str = "cuda"):
    """The KAIR/BSRGAN GAN-SSL family (KAIR) through the train and test CLIs
    at the files' widths on the ``kair_fixtures`` data, with cv2 hidden (the
    port's own resize, JPEG and PNG decode run in the loader's processes).
    For each: KR_ITERS iterations with a save (every loss finite under the
    recipe's keys, K1 once per iteration, the plain SSL forward never on the
    card), the training state reloaded into a fresh model bit for bit,
    ``--auto_resume`` to KR_RESUME_ITERS, then the test CLI with the shipped
    test YAML's model and G on the last ``net_g`` over the BlindLR set, whole
    and tiled; the loader alone; K1 held against its plain version on
    BSRGAN-SSL's SR of KR_HOLD pairs with the stride-3 mask, for each of
    KR_HOLD_SEEDS (the kernel phase holds and times it at each recipe's
    shape).  Returns the K1 launches by recipe and the holds."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig
    from ssl_tpu_torch.utils.kair_options import kair_to_opt
    from ssl_tpu_torch.utils.options import parse_json_options, set_by_dotted

    plain_on_card = []
    plain = ssg_cuda.ssl_loss_sums_reference

    def counted_plain(sr, *args, **kw):
        if sr.is_cuda:
            plain_on_card.append(tuple(sr.shape))
        return plain(sr, *args, **kw)

    try:
        import yaml
    except ImportError:
        yaml = None
    results, shipped, holds, launches_by = {}, {}, [], {}
    with tempfile.TemporaryDirectory(prefix="kair_smoke_") as root:
        t0 = time.perf_counter()
        d, edge_share = kair_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        dev = ["--device", device] if device != "cuda" else []
        for recipe, spec in KAIR.items():
            path, shipped[recipe] = kair_file(recipe, d, root)
            force = [f"datasets:train:dataset_enlarge_ratio={KR_ENLARGE}"] + spec["force"]
            opt = kair_to_opt(parse_json_options(path))
            for entry in force:
                set_by_dotted(opt, entry)
            opt.update(is_train=True, num_devices=1)
            exp = os.path.join(root, "experiments", opt["name"])
            args = ["-opt", path] + dev + ["--force_yml"] + force
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ssg_cuda.ssl_loss_sums_reference = counted_plain
            try:
                with without_cv2():
                    state, logged, launches, wall = run_train_cli(root, args, device)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
                files = [f"models/net_g_{KR_ITERS}.pth", f"models/net_d_{KR_ITERS}.pth",
                         f"training_states/{KR_ITERS}.state"]
                missing = [f for f in files if not os.path.isfile(os.path.join(exp, f))]
                fresh = build_model(opt, device=device)
                reloaded, it = fresh.load_training_state(
                    fresh.init_state(seed=1), os.path.join(exp, "training_states"), KR_ITERS)
                want, got = state_tensors(state), state_tensors(reloaded)
                differ = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
                step = (state.step, reloaded.step, it)
                kinds = (type(state.net_g).__name__, type(state.net_d).__name__,
                         type(state.opt_g).__name__)
                del fresh, reloaded, state
                gc.collect()
                with without_cv2():
                    resumed, logged_r, launches_r, wall_r = run_train_cli(
                        root, args + [f"train:total_iter={KR_RESUME_ITERS}", "--auto_resume"],
                        device)
            finally:
                ssg_cuda.ssl_loss_sums_reference = plain
            if launches != KR_ITERS or launches_r != KR_RESUME_ITERS - KR_ITERS:
                fail(f"kair {recipe}: K1 launched {launches} and {launches_r} times in "
                     f"{KR_ITERS} and {KR_RESUME_ITERS - KR_ITERS} iterations")
            if plain_on_card:
                fail(f"kair {recipe}: the plain SSL forward ran on the card at {plain_on_card}")
            if [x["iter"] for x in logged + logged_r] != list(range(1, KR_RESUME_ITERS + 1)):
                fail(f"kair {recipe}: logged iterations {[x['iter'] for x in logged + logged_r]}")
            for x in logged + logged_r:
                bad = {k: x.get(k) for k in RC_LOSSES if not np.isfinite(x.get(k, np.nan))}
                if bad:
                    fail(f"kair {recipe}: iteration {x['iter']}: losses missing or not finite: "
                         f"{bad}")
            if missing or differ or step != (KR_ITERS, KR_ITERS, KR_ITERS) or \
                    resumed.step != KR_RESUME_ITERS:
                fail(f"kair {recipe}: files missing {missing}; reloaded tensors differing "
                     f"{differ[:5]}; steps {step}, resumed to {resumed.step}")
            if kinds != (spec["test"]["network_g"]["type"], "UNetDiscriminatorSN", "Adam"):
                fail(f"kair {recipe}: trained {kinds}")
            train_set = opt["datasets"]["train"]
            if (train_set["batch_size_per_gpu"], train_set["H_size"]) != (spec["batch"],
                                                                          spec["gt"]):
                fail(f"kair {recipe}: trained at batch {train_set['batch_size_per_gpu']} and "
                     f"{train_set['H_size']}^2, the kernel phase held K1 at "
                     f"{spec['batch']} and {spec['gt']}^2")
            launches_by[recipe] = launches + launches_r

            # K1 held on BSRGAN-SSL's SR of KR_HOLD training pairs for each seed
            cfg = SSGConfig(search=25, window=9, sigma=0.004)
            pairs, item_ms = kair_pairs(opt, KR_HOLD, device)
            if recipe == "BSRGANSSL":
                sets = [pairs] + [kair_pairs(opt, KR_HOLD, device, seed)[0]
                                  for seed in KR_HOLD_SEEDS[1:]]
                with torch.no_grad():
                    srs = [resumed.net_g.eval()(p["lq"]).contiguous() for p in sets]
                    flax_variance_init(resumed.net_g, torch.Generator().manual_seed(0))
                    wide = resumed.net_g(sets[0]["lq"]).contiguous()
            del resumed
            gc.collect()
            torch.cuda.empty_cache()
            if recipe == "BSRGANSSL":
                for seed, p, sr in zip(KR_HOLD_SEEDS, sets, srs):
                    errs, ties = hold_k1(f"kair {recipe} SR, seed {seed}", sr, p["gt"],
                                         p["mask"], cfg, 1e-4, ssg_cuda.ssg_loss_fwd_cuda,
                                         map_error_ties=True, float64=True)
                    if not ties["d_sr_max_abs"] > 0:
                        fail(f"kair {recipe}: the SSL gradient of the SR K1 was held on is 0")
                    holds.append({"recipe": recipe, "seed": seed, "shape": list(sr.shape),
                                  "max_abs_err": errs, "ties": ties,
                                  "mask_stride": opt["train"]["mask_stride"],
                                  "mask_share": float(p["mask"].mean()),
                                  "sr_range": [float(sr.min()), float(sr.max())]})
                    emit({"phase": "kair", "k1_hold": holds[-1]})
                wide_hold = hold_k1_wide(f"kair {recipe} wide-range SR", wide, sets[0]["gt"],
                                         sets[0]["mask"], cfg)
                emit({"phase": "kair", "k1_wide_range_hold": wide_hold})
                del sets, srs, wide
            del pairs
            torch.cuda.empty_cache()
            # the loader: each worker makes whole batches, so a batch takes one
            # process batch x item_ms, and the workers give one every that / workers
            workers = opt["datasets"]["train"]["num_worker_per_gpu"]
            loader = {"recipe": recipe, "host_ms_per_item": item_ms,
                      "one_process_ms_per_batch": spec["batch"] * item_ms,
                      "workers": workers,
                      "loader_ms_per_batch": spec["batch"] * item_ms / workers,
                      "first_batch_wait_ms": 1e3 * logged[0]["data_time"],
                      "measured_by": f"{KR_HOLD} items made in this process, cv2 hidden; "
                                     "first_batch_wait_ms from the train CLI's data timer"}
            emit({"phase": "kair", "loader": loader})

            test_spec = spec["test"]
            shipped_test = os.path.join(ROOT, "options", "test", recipe,
                                        f"test_{recipe}_DF2K_OST_x4.yml")
            if yaml is not None:
                with open(shipped_test) as f:
                    y = yaml.safe_load(f)
                if (y["model_type"], y["network_g"]) != (test_spec["model_type"],
                                                         test_spec["network_g"]):
                    fail(f"kair {recipe}: the phase's test options differ from {shipped_test}")
            test_opt = {"name": f"test_{recipe}", "model_type": test_spec["model_type"],
                        "scale": SCALE, "num_devices": 1, "manual_seed": 0, "tile_size": 800,
                        "tile_pad": 32, "tile_process": False,
                        "datasets": {"test_1": {"name": "BlindLR", "type": "MultiLROneGTDataset",
                                                "dataroot_gt": d["test_gt"],
                                                "dataroot_lq": d["test_lq"],
                                                "io_backend": {"type": "disk"}}},
                        "network_g": test_spec["network_g"],
                        "path": {"pretrain_network_g": os.path.join(
                            exp, "models", f"net_g_{KR_RESUME_ITERS}.pth"),
                            "param_key_g": "params"},
                        "val": {"save_img": True, "metrics": TEST_METRICS}}
            test_path = os.path.join(root, f"test_{recipe}.json")
            with open(test_path, "w") as f:
                json.dump(test_opt, f)
            tests = {}
            n_images = RE_TEST_GT * len(RE_VARIANTS)
            for label, extra in (("whole", []), ("tiled", [
                    "--force_yml", f"name=test_{recipe}_tiled", "tile_process=true",
                    f"tile_size={CLI_TILE[0]}", f"tile_pad={CLI_TILE[1]}"])):
                t0 = time.perf_counter()
                with without_cv2(), metric_seconds() as metric_s:
                    out = test_cli.test_pipeline(root, ["-opt", test_path] + dev + extra)["BlindLR"]
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if set(out) != set(TEST_METRICS) or not all(np.isfinite(v) for v in out.values()):
                    fail(f"kair {recipe}: test CLI ({label}) metrics {out}")
                tests[label] = test_record(out, seconds, metric_s, n_images)
            ms = per_iter_ms(logged, "time")
            results[recipe] = {
                "model": opt["model_type"], "network_g": opt["network_g"],
                "network_d": opt["network_d"], "optim_g": kinds[2],
                "batch": opt["datasets"]["train"]["batch_size_per_gpu"],
                "h_size": opt["datasets"]["train"]["H_size"],
                "lq_size": opt["datasets"]["train"]["H_size"] // SCALE,
                "workers": opt["datasets"]["train"]["num_worker_per_gpu"],
                "mask_stride": opt["train"]["mask_stride"],
                "gan_type": opt["train"]["gan_opt"]["gan_type"],
                "ms_per_iter": ms, "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
                "first_iter_extra_ms": 1e3 * logged[0]["time"] - ms,
                "first_data_wait_ms": 1e3 * logged[0]["data_time"],
                "resumed_first_iter_ms": 1e3 * logged_r[-1]["time"], "peak_mem_gb": peak_gb,
                "loader": loader, "wall_s": wall, "resumed_wall_s": wall_r,
                "k1_launches": {"train": launches, "resumed": launches_r},
                "k1_shape": [spec["batch"], 3, spec["gt"], spec["gt"]],
                "losses_last_iter": {k: logged[-1][k] for k in RC_LOSSES},
                "reloaded_tensors_bit_for_bit": len(want), "test": tests,
                "test_lpips_dists_s": lpips_dists_s(tests)}
            emit({"phase": "kair", "recipe": recipe, **results[recipe]})
            gc.collect()
            torch.cuda.empty_cache()
    emit({"phase": "kair", "config": {r: f"options/train/{r}/train_{r}_DF2K_OST_x4.json"
                                      for r in KAIR},
          "test_config": {r: f"options/test/{r}/test_{r}_DF2K_OST_x4.yml" for r in KAIR},
          "train_images": KR_TRAIN, "gt_image": KR_GT_IMG, "mask_edge_share": edge_share,
          "decoder": "ssl_tpu_torch/utils/png.py (cv2 hidden)",
          "resize_and_jpeg": "ssl_tpu_torch/data/bsrgan_degradation.py resize, "
                             "ssl_tpu_torch/native/pipeline.cpp jpeg_libjpeg_roundtrip "
                             "(cv2 hidden)",
          "fixtures_s": fixtures_s,
          "swinir_netG_through_force_yml": KAIR["SwinIRGANSSL_BSRGAN"]["force"],
          "reduced": {"batch_size_per_gpu": {r: [shipped[r]["batch"], KAIR[r]["batch"]]
                                             for r in KAIR if shipped[r]["batch"]
                                             != KAIR[r]["batch"]},
                      "total_iter": [{r: shipped[r]["iterations"] for r in KAIR},
                                     f"{KR_ITERS}, a save, --auto_resume to {KR_RESUME_ITERS}"],
                      "dataset_enlarge_ratio": [1, KR_ENLARGE], "validation": "none",
                      "test_sets": ["7 sets of options/test/<recipe>", "BlindLR of "
                                    f"{RE_TEST_GT} GT x {len(RE_VARIANTS)} variants, whole "
                                    "and tiled"]},
          "k1_launches": sum(launches_by.values()),
          "ms_per_iter": {r: v["ms_per_iter"] for r, v in results.items()},
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "card": card() if device == "cuda" else None})
    return launches_by, holds


def ssl_base_train_cfg(d: dict) -> dict:
    """options/diffusion/ssl_base.yml as a dict (the card's machine may lack
    yaml): ``ssl_base_cfg``'s model, sslopt and train blocks without the
    flash switch (the CLI gets it as an override), the shipped degradation
    block, the data block on ``diffusion_cli_fixtures``'s folders, and this
    phase's cuts (TRAIN_MINI_STEPS mini-steps an update, DC_STEPS
    mini-steps, a log line every DC_LOG, checkpoints and previews every
    DC_SAVE)."""
    cfg = ssl_base_cfg()
    del cfg["model"]["use_flash_attention"]
    cfg["degradation"] = {
        "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.3, 1.5], "gaussian_noise_prob": 0.5,
        "noise_range": [1, 15], "poisson_scale_range": [0.05, 2.0], "gray_noise_prob": 0.4,
        "jpeg_range": [60, 95], "second_blur_prob": 0.5, "resize_prob2": [0.3, 0.4, 0.3],
        "resize_range2": [0.6, 1.2], "gaussian_noise_prob2": 0.5, "noise_range2": [1, 12],
        "poisson_scale_range2": [0.05, 1.0], "gray_noise_prob2": 0.4, "jpeg_range2": [60, 100],
        "no_degradation_prob": 0.01, "queue_size": 0}
    cfg["data"] = {"crop_size": TRAIN_SIZE, "batch_size": TRAIN_B, "num_workers": DC_WORKERS,
                   "train": {"type": "TwoStageDegradationImgMaskDataset",
                             "dataroot_gt": [d["gt"]], "dataroot_gt_mask": [d["mask"]]}}
    cfg["train"].update(accumulate_grad_batches=TRAIN_MINI_STEPS, max_steps=DC_STEPS,
                        log_every=DC_LOG, save_every=DC_SAVE, image_every=DC_SAVE)
    return cfg


def diffusion_cli_fixtures(root: str, device: str) -> tuple[dict, float]:
    """DC_TRAIN GT PNGs of TRAIN_SIZE^2 made on the card (``smooth_picture``,
    written through ``utils/img_util.py``), their ``.mat`` masks from the
    ``generate_mask`` entry point at threshold 20, and one SERVE_LQ^2 LQ PNG
    for the test CLI.  Returns the folders and the masks' share of edge
    pixels."""
    import numpy as np
    import torch
    from ssl_tpu_torch.scripts import generate_mask
    from ssl_tpu_torch.utils.img_util import imwrite

    d = {k: os.path.join(root, k) for k in ("gt", "lq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(2)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR file
        imwrite(np.ascontiguousarray(img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]),
                path)

    for i in range(DC_TRAIN):
        save(smooth_picture(TRAIN_SIZE, TRAIN_SIZE, gen, device),
             os.path.join(d["gt"], f"{i:04d}.png"))
    save(smooth_picture(SERVE_LQ, SERVE_LQ, gen, device), os.path.join(d["lq"], "lq0.png"))
    d["mask"] = generate_mask.main(["--input", d["gt"], "--output", os.path.join(root, "masks"),
                                    "--threshold", "20"])
    with open(os.path.join(os.path.dirname(d["mask"]), "edge_pixel_stats.txt")) as f:
        shares = [float(line.split()[2]) for line in f if line.strip()]
    return d, float(np.mean(shares))


def host_degrader_hold(seed: int = 3) -> dict:
    """The host C++ (``ssl_tpu_torch/native``) against its numpy plain
    versions on a 2 x 512^2 batch of seeded pictures: ``filter2d`` with two
    of the loader's 21 x 21 blur kernels and the JPEG round trip at two
    qualities, each within one uint8 level after rounding on at most
    RE_TIE_SHARE of the values."""
    import numpy as np
    import torch
    from ssl_tpu_torch import native
    from ssl_tpu_torch.data.realesr_degradation import filter2d_np, jpeg_np
    from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth

    gen = torch.Generator().manual_seed(seed)
    imgs = torch.stack([smooth_picture(TRAIN_SIZE, TRAIN_SIZE, gen, "cpu") / 255
                        for _ in range(TRAIN_B)]).permute(0, 2, 3, 1).numpy()
    np.random.seed(seed)
    kernels = np.stack([_KernelSynth({}).sample()[0] for _ in range(TRAIN_B)])
    quality = [60.0, 95.0]
    t0 = time.perf_counter()
    native.library()                      # g++ builds it here in a fresh checkout
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    filtered = native.filter2d_batch(imgs, kernels)
    t1 = time.perf_counter()
    jpeg = native.jpeg_roundtrip_batch(imgs, quality)
    t2 = time.perf_counter()
    plain = {"filter2d": np.stack([filter2d_np(x, k) for x, k in zip(imgs, kernels)]),
             "jpeg": np.stack([jpeg_np(x, q) for x, q in zip(imgs, quality)])}
    out = {"shape": list(imgs.shape), "kernel_sizes": [int((k.sum(0) != 0).sum()) for k in kernels],
           "library_build_s": build_s, "ms": {"filter2d": 1e3 * (t1 - t0), "jpeg": 1e3 * (t2 - t1)}}
    for name, got in (("filter2d", filtered), ("jpeg", jpeg)):
        levels = np.abs(np.round(got * 255) - np.round(plain[name] * 255))
        share = float((levels > 0).mean())
        out[name] = {"max_abs": float(np.abs(got - plain[name]).max()),
                     "values_one_level_off": int((levels > 0).sum()), "share": share}
        if levels.max() > 1 or share > RE_TIE_SHARE:
            fail(f"diffusion_cli: the host C++ {name} is {levels.max()} levels from its plain "
                 f"version on {share} of the values (hold: 1 level on at most {RE_TIE_SHARE})")
    return out


def phase_diffusion_cli(device: str = "cuda"):
    """StableSR-SSL training through its CLI (``ssl_tpu_torch.diffusion.main
    --train``) at the full width of options/diffusion/ssl_base.yml, with
    ``model.use_flash_attention=true`` as a dotlist override, on the
    ``diffusion_cli_fixtures`` data: DC_STEPS mini-steps (one update of
    TRAIN_MINI_STEPS),
    the training state reloaded into a fresh state bit for bit,
    ``--resume auto`` to DC_RESUME_STEPS (the second update), then the test
    CLI on the two checkpoints.  K1 once, K2's forward 17 and its backward 15 times per
    mini-step; the weights move at every TRAIN_MINI_STEPS-th mini-step only.  Returns the
    launches of the CLI's training runs by kernel."""
    import gc
    import pickle
    import tempfile
    import types

    import numpy as np
    import torch
    from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
    from ssl_tpu_torch.diffusion import main as dmain
    from ssl_tpu_torch.diffusion import test_cli
    from ssl_tpu_torch.diffusion.ddpm_ssl import StableSRSSL, trainable
    from ssl_tpu_torch.ops import attention_cuda, ssg_cuda
    from ssl_tpu_torch.utils.img_util import imread
    from ssl_tpu_torch.utils.weight_port import params_to_jax

    per_step_expected = {"k1": 1, "k2_fwd": TRAIN_K2_FWD, "k2_bwd": TRAIN_K2_BWD}
    with tempfile.TemporaryDirectory(prefix="diffusion_cli_smoke_") as root:
        t0 = time.perf_counter()
        d, edge_share = diffusion_cli_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        cfg = ssl_base_train_cfg(d)
        cfg_path = os.path.join(root, "ssl_base.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        logdir = os.path.join(root, "logs")
        hold = host_degrader_hold()
        counters = (ssg_cuda, "launches"), (attention_cuda, "launches"), \
            (attention_cuda, "bwd_launches")

        def counts():
            return dict(zip(per_step_expected, (getattr(m, a) for m, a in counters)))

        def run(extra):
            """One CLI run: its records, the live state and degrader, the K1 and
            K2 launches by mini-step and by kernel, and wall seconds."""
            records, steps, live = [], [], {}
            call = StableSRSSL.train_step

            def step(self, state, batch, draws=None):
                if "start" not in live:
                    live["start"] = [p.detach().clone() for p in trainable(state.params)]
                before = counts()
                out = call(self, state, batch, draws)
                steps.append({k: v - before[k] for k, v in counts().items()})
                return out

            def on_iteration(record, state, degrader):
                moved = not all(torch.equal(a, p)
                                for a, p in zip(live["start"], trainable(state.params)))
                if moved:
                    live["start"] = [p.detach().clone() for p in trainable(state.params)]
                records.append(dict(record, moved=moved))
                live.update(state=state, degrader=degrader)

            ssg_cuda.launches = 0
            reset_k2_counts()
            StableSRSSL.train_step = step
            args = types.SimpleNamespace(base=cfg_path, logdir=logdir, device=device,
                                         overrides=["model.use_flash_attention=true"] + extra,
                                         resume="auto" if extra else None)
            try:
                t0 = time.perf_counter()
                state = dmain.train(args, on_iteration)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                StableSRSSL.train_step = call
            kernels = {**attention_cuda.fwd_kernel_launches, **attention_cuda.bwd_kernel_launches,
                       **counts()}
            return records, state, live["degrader"], steps, kernels, wall

        def check(records, steps, first, last):
            label = f"mini-steps {first}-{last}"
            if [r["step"] for r in records] != list(range(first, last + 1)):
                fail(f"diffusion_cli: {label}: the CLI ran steps {[r['step'] for r in records]}")
            for r in records:
                if not all(np.isfinite(v) for v in r["logs"].values()):
                    fail(f"diffusion_cli: mini-step {r['step']} logged {r['logs']}")
                if r["moved"] != (r["step"] % TRAIN_MINI_STEPS == 0):
                    fail(f"diffusion_cli: after mini-step {r['step']} the weights "
                         f"{'moved' if r['moved'] else 'did not move'}")
            if any(s != per_step_expected for s in steps):
                fail(f"diffusion_cli: {label}: launches per mini-step {steps}, expected "
                     f"{per_step_expected}")

        torch.cuda.reset_peak_memory_stats()
        records, state, degrader, steps, kernels, wall = run([])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(records, steps, 1, DC_STEPS)
        idle = [k_ for k_, c in kernels.items() if c == 0 and not k_.endswith("_bf16")]
        if idle:
            fail(f"diffusion_cli: kernels {idle} were never launched: {kernels}")
        for f in [f"ckpt_{DC_STEPS}.pkl", f"train_state_{DC_STEPS}.pkl"] + \
                 [f"images/train/{k}_gs-{DC_SAVE:06d}.png"
                  for k in ("inputs", "gt", "reconstruction", "pred_x0")]:
            if not os.path.isfile(os.path.join(logdir, f)):
                fail(f"diffusion_cli: {f} was not written")

        # ckpt_<DC_SAVE>.pkl in the JAX layout; train_state_<DC_STEPS>.pkl reloaded bit
        # for bit
        model = dmain.build_from_config(cfg)
        fresh = model.init_state(seed=1, device=device)
        fresh_degrader = RealESRGANDegrader(cfg["degradation"], scale=1, seed=1,
                                            queue_size=cfg["degradation"]["queue_size"])
        want = params_to_jax("StableSRSSL", fresh.params)
        with open(os.path.join(logdir, f"ckpt_{DC_SAVE}.pkl"), "rb") as f:
            got = pickle.load(f)

        def layout(tree, path=""):
            if isinstance(tree, dict):
                return {k_: v for key in sorted(tree) for k_, v in
                        layout(tree[key], f"{path}/{key}").items()}
            return {path: (tuple(tree.shape), str(tree.dtype), type(tree).__name__)}
        if layout(got) != layout(want):
            diff = set(layout(got).items()) ^ set(layout(want).items())
            fail(f"diffusion_cli: ckpt_{DC_SAVE}.pkl is not in the JAX layout: "
                 f"{sorted(diff)[:6]}")
        n_leaves = len(layout(want))
        dmain.load_train_state(os.path.join(logdir, f"train_state_{DC_STEPS}.pkl"), fresh,
                               fresh_degrader)
        n_tensors = 0
        for name in ("params", "ema_params"):
            for a, b in zip(trainable(getattr(state, name)), trainable(getattr(fresh, name))):
                n_tensors += 1
                if not torch.equal(a, b):
                    fail(f"diffusion_cli: a reloaded {name} tensor differs from the saved state")
        want_opt, got_opt = state.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
        if sorted(want_opt) != sorted(got_opt):
            fail("diffusion_cli: the reloaded AdamW state has other parameters")
        for pid, st in want_opt.items():
            for k_, v in st.items():
                n_tensors += 1
                if not torch.equal(v, got_opt[pid][k_]):
                    fail(f"diffusion_cli: reloaded AdamW state {pid}.{k_} differs")
        same_deg = degrader.get_state(), fresh_degrader.get_state()
        if not (torch.equal(state.generator.get_state(), fresh.generator.get_state())
                and (state.step, state.mini_step) == (fresh.step, fresh.mini_step) == (DC_STEPS, 0)
                and torch.equal(same_deg[0]["np_rng"][1], same_deg[1]["np_rng"][1])
                and same_deg[0]["np_rng"][2:] == same_deg[1]["np_rng"][2:]
                and same_deg[0]["py_rng"] == same_deg[1]["py_rng"]):
            fail("diffusion_cli: the reloaded generator, step or degrader streams differ")
        del model, fresh, state, degrader
        gc.collect()
        torch.cuda.empty_cache()

        records_r, resumed, _, steps_r, kernels_r, wall_r = run(
            [f"train.max_steps={DC_RESUME_STEPS}"])
        check(records_r, steps_r, DC_STEPS + 1, DC_RESUME_STEPS)
        if resumed.step != DC_RESUME_STEPS or not os.path.isfile(
                os.path.join(logdir, f"ckpt_{DC_RESUME_STEPS}.pkl")):
            fail(f"diffusion_cli: the resumed run ended at step {resumed.step} or wrote no "
                 f"ckpt_{DC_RESUME_STEPS}.pkl")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        # the test CLI on both checkpoints: one request each
        test_cfg = os.path.join(root, "ssl_base_flash.json")
        with open(test_cfg, "w") as f:
            json.dump(dmain.apply_dotlist(cfg, ["model.use_flash_attention=true"]), f)
        request_ms, outs = {}, {}
        restore = test_cli.restore

        def timed_restore(model, state, lq_up, *a, **kw):
            t0 = time.perf_counter()
            img = restore(model, state, lq_up, *a, **kw)
            torch.cuda.synchronize()
            request_ms[ckpt] = 1e3 * (time.perf_counter() - t0)
            return img
        test_cli.restore = timed_restore
        try:
            for ckpt in (DC_STEPS, DC_RESUME_STEPS):
                out_dir = os.path.join(root, f"restored_{ckpt}")
                t0 = time.perf_counter()
                test_cli.main(["--config", test_cfg, "--ckpt",
                               os.path.join(logdir, f"ckpt_{ckpt}.pkl"), "--init-img", d["lq"],
                               "--outdir", out_dir, "--ddpm_steps", str(DC_TEST_STEPS)]
                              + (["--device", device] if device != "cuda" else []))
                outs[ckpt] = imread(os.path.join(out_dir, "lq0.png"), float32=False)
                request_ms[f"cli_{ckpt}_s"] = time.perf_counter() - t0
        finally:
            test_cli.restore = restore
        first, second = outs[DC_STEPS], outs[DC_RESUME_STEPS]
        if first.shape != (4 * SERVE_LQ, 4 * SERVE_LQ, 3) or np.array_equal(first, second):
            fail(f"diffusion_cli: the two checkpoints restored {first.shape} images "
                 "that are the same")
        image_diff = float(np.abs(first.astype(int) - second.astype(int)).mean())

    def mean(xs):
        return sum(xs) / len(xs)

    def stats(recs):
        warm = [r for r in recs[1:] if r["step"] % TRAIN_MINI_STEPS]
        applying = [r for r in recs if r["step"] % TRAIN_MINI_STEPS == 0]
        it = mean([r["iter_s"] for r in warm])
        degrade = mean([r["degrade_s"] for r in recs])
        parts = {k: mean([r["degrade_parts"].get(k, 0.0) for r in recs])
                 for k in recs[0]["degrade_parts"]}
        return {"ms_per_mini_step_warm": 1e3 * it,
                "ms_per_mini_step_applying": 1e3 * mean([r["iter_s"] for r in applying]),
                "data_wait_ms_per_mini_step": 1e3 * mean([r["data_s"] for r in warm]),
                "data_wait_share": mean([r["data_s"] for r in warm]) / it,
                "degrader_ms_per_batch": 1e3 * degrade,
                "degrader_parts_ms": {k: 1e3 * v for k, v in parts.items()},
                "jpeg_share_of_degrader": parts.get("jpeg", 0.0) / degrade,
                "degrader_share_of_iteration": mean([r["degrade_s"] for r in warm]) / it,
                "step_ms_warm": 1e3 * mean([r["iter_s"] - r["data_s"] - r["degrade_s"]
                                            for r in warm]),
                "first_iteration_extra_ms": 1e3 * (recs[0]["iter_s"] - it),
                "first_data_wait_ms": 1e3 * recs[0]["data_s"]}

    launches = {k: kernels[k] + kernels_r[k] for k in kernels}
    emit({"phase": "diffusion_cli", "config": "options/diffusion/ssl_base.yml",
          "override": "model.use_flash_attention=true", "train_images": DC_TRAIN,
          "size": TRAIN_SIZE, "batch": TRAIN_B, "workers": DC_WORKERS,
          "accumulate": TRAIN_MINI_STEPS,
          "fixtures_s": fixtures_s, "mask_edge_share": edge_share, "decoder": decoder(),
          "reduced": {"accumulate_grad_batches": [SHIPPED_ACCUMULATE, TRAIN_MINI_STEPS],
                      "max_steps": [800000, DC_STEPS], "log_every": [100, DC_LOG],
                      "save_every": [1000, DC_SAVE], "image_every": [1000, DC_SAVE],
                      "resumed_to": DC_RESUME_STEPS,
                      "test_cli": f"ckpt_{DC_STEPS}.pkl and ckpt_{DC_RESUME_STEPS}.pkl, one "
                                  f"{4 * SERVE_LQ}^2 request each, {DC_TEST_STEPS} steps"},
          "run": stats(records), "resumed": stats(records_r), "wall_s": wall,
          "resumed_wall_s": wall_r, "peak_mem_gb": peak_gb,
          "launches_per_mini_step": per_step_expected, "launches": launches,
          "losses_last": records[-1]["logs"], "ckpt_leaves": n_leaves,
          "reloaded_tensors_bit_for_bit": n_tensors,
          "test_cli_request_ms": {k: v for k, v in request_ms.items() if isinstance(k, int)},
          "test_cli_wall_s": {k: v for k, v in request_ms.items() if isinstance(k, str)},
          "restored_images_mean_abs_diff": image_diff, "host_cpp_hold": hold,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    return launches


def zoo_loss(sr, gt, mask, setting, dtype, device) -> dict:
    """ssl_loss with ``setting`` on ``device`` in ``dtype``: l1, kl, d_sr of
    l1 + kl (on the host in float64) and the call's seconds, forward and
    backward, ending in a synchronise."""
    import torch
    from ssl_tpu_torch.losses.ssl_loss import ssl_loss
    x = torch.as_tensor(sr, dtype=dtype, device=device).requires_grad_(True)
    g = torch.as_tensor(gt, dtype=dtype, device=device)
    m = torch.as_tensor(mask, dtype=dtype, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    l1, kl = ssl_loss(x, g, m, setting)
    (l1 + kl).backward()
    if device != "cpu":
        torch.cuda.synchronize()
    return {"l1": l1.item(), "kl": kl.item(), "d_sr": x.grad.double().cpu(),
            "s": time.perf_counter() - t0}


def zoo_call(sr, gt, mask, setting, device):
    """A function that runs ``ssl_loss`` forward and backward in float32 on
    ``device`` with no copy to the host, for ``time_ms`` and
    ``profiled_launches``."""
    import torch
    from ssl_tpu_torch.losses.ssl_loss import ssl_loss
    x = torch.as_tensor(sr, dtype=torch.float32, device=device).requires_grad_(True)
    g = torch.as_tensor(gt, dtype=torch.float32, device=device)
    m = torch.as_tensor(mask, dtype=torch.float32, device=device)

    def call():
        x.grad = None
        l1, kl = ssl_loss(x, g, m, setting)
        (l1 + kl).backward()
    return call


def zoo_percep(loss, x, gt) -> dict:
    """PerceptualSimLoss's four terms and d_x of their sum, and the call's
    seconds."""
    import torch
    x = x.clone().requires_grad_(True)
    t0 = time.perf_counter()
    terms = loss(x, gt)
    sum(terms).backward()
    if x.is_cuda:
        torch.cuda.synchronize()
    return {"terms": [t.item() for t in terms], "d_x": x.grad.double().cpu(),
            "s": time.perf_counter() - t0}


def zoo_percep_loss():
    """PerceptualSimLoss at five VGG19 layers with every term on (the simself
    tiles' maps kept flat: without a neighbourhood the tile grid has no map
    layout), its tower seeded."""
    from ssl_tpu_torch.losses.feature_sim import PerceptualSimLoss
    return PerceptualSimLoss(
        layer_weights={"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0, "conv4_4": 1.0,
                       "conv5_4": 1.0},
        perceptual_weight=1.0, style_weight=0.5, simself_weight=1.0,
        simself_channel_weight=1.0, rearrange_back=False)


def zoo_cpu_ref(kind: str, *args) -> dict:
    """The CPU float64 reference of one zoo hold, in a worker process of
    ZOO_REF_THREADS threads: ``zoo_loss`` (kind 'loss') or ``zoo_percep``
    (kind 'percep')."""
    import torch
    torch.set_num_threads(ZOO_REF_THREADS)
    if kind == "loss":
        return zoo_loss(*args, torch.float64, "cpu")
    x, gt = (torch.from_numpy(a) for a in args)
    return zoo_percep(zoo_percep_loss().double(), x, gt)


def zoo_compare(got: dict, ref: dict, keys=("l1", "kl"), grad="d_sr") -> dict:
    """Relative errors of the scalars ``keys``, and the relative L2 of the
    gradient ``grad`` (0 where both are 0: a saturated softmax passes none)."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-300)
    norm = float(ref[grad].norm())
    d = float((got[grad] - ref[grad]).norm())
    return {**{k: rel(got[k], ref[k]) for k in keys}, grad: d / norm if norm else d}


def zoo_gather_holds(device: str, inputs, setting) -> dict:
    """(a) The gather route (``setting``, ``impl: scan`` with the capacity at
    the largest edge count) against K1's dense route on ``inputs`` (the
    ESRGAN-SSL step's shape): l1 within 1e-4 and kl within 1e-3 relative,
    d_sr within D_SR_REL_L2; each route's ms forward + backward (CUDA events
    over 3 calls after that held one), device launches a call and peak
    memory."""
    import torch

    sr, gt, mask = inputs
    routes = {"k1_dense": setting._replace(impl="dense"), "gather_scan": setting}
    out, runs = {"edges_per_image": [int(c) for c in mask.reshape(len(mask), -1).sum(1)]}, {}
    for name, route in routes.items():
        runs[name] = zoo_loss(sr, gt, mask, route, torch.float32, device)
        call = zoo_call(sr, gt, mask, route, device)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(call, 3, warmup=0)
        out[name] = {"ms_fwd_bwd": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "device_launches": profiled_launches(call),
                     "l1": runs[name]["l1"], "kl": runs[name]["kl"]}
    err = zoo_compare(runs["gather_scan"], runs["k1_dense"])
    out["gather_vs_k1"] = err
    if err["l1"] > 1e-4 or err["kl"] > 1e-3 or err["d_sr"] > D_SR_REL_L2:
        fail(f"zoo: the gather route against K1's at b{MAIN_B} 3x{MAIN_GT}^2: {err} (holds: "
             f"l1 1e-4, kl 1e-3, d_sr {D_SR_REL_L2})")
    return out


def zoo_f64_holds(device: str, cases: dict, refs: dict) -> dict:
    """(b), (c) Each case's (inputs, setting) through ``ssl_loss`` in float64
    on the card against ``refs`` (the CPU's float64, futures) within
    ZOO_F64_RTOL.  Returns the readings and, under "refs", the CPU results."""
    import torch

    out, done = {}, {}
    for key, (inputs, setting) in cases.items():
        card64 = zoo_loss(*inputs, setting, torch.float64, device)
        done[key] = refs[key].result()
        f64 = zoo_compare(card64, done[key])
        out[key] = {"l1": done[key]["l1"], "kl": done[key]["kl"], "card_f64_vs_cpu_f64": f64,
                    "cpu_f64_s": done[key]["s"]}
        if max(f64.values()) > ZOO_F64_RTOL:
            fail(f"zoo: {key} card against CPU in float64: {f64} (hold {ZOO_F64_RTOL})")
    return {"readings": out, "refs": done}


def zoo_f32_times(device: str, cases: dict, holds: dict) -> None:
    """Each case in float32 on the card: its error against the CPU's float64
    (the first float32 call, which also warms the case up) and its ms
    forward + backward (CUDA events over ZOO_TIME_ITERS calls after it),
    added to ``holds``' readings."""
    import torch

    for key, (inputs, setting) in cases.items():
        card32 = zoo_loss(*inputs, setting, torch.float32, device)
        ms = time_ms(zoo_call(*inputs, setting, device), ZOO_TIME_ITERS, warmup=0)
        holds["readings"][key].update(ms_f32=ms, card_f32_vs_cpu_f64=zoo_compare(
            card32, holds["refs"][key]))


def zoo_percep_holds(device: str, inputs, ref) -> dict:
    """(e) ``zoo_percep_loss``: the four terms and d_x on the card against
    ``ref`` (the CPU's float64 on ``inputs``, a future) within ZOO_F64_RTOL."""
    import torch

    x, gt = (torch.from_numpy(a).to(device) for a in inputs)
    got = zoo_percep(zoo_percep_loss().double().to(device), x, gt)
    ref = ref.result()
    err = zoo_compare(got, ref, keys=(), grad="d_x")
    err["terms"] = [abs(a - b) / abs(b) for a, b in zip(got["terms"], ref["terms"])]
    if max(err["terms"] + [err["d_x"]]) > ZOO_F64_RTOL:
        fail(f"zoo: PerceptualSimLoss card against CPU in float64: {err}")
    return {"terms_f64": ref["terms"], "card_f64_vs_cpu_f64": err, "cpu_f64_s": ref["s"]}


def zoo_percep_times(device: str) -> dict:
    """``zoo_percep_loss`` in float32 at b TRAIN_B 3 x TRAIN_SIZE^2: ms forward
    + backward (CUDA events over 3 calls after one) and peak memory."""
    import torch

    loss32 = zoo_percep_loss().to(device)
    big = torch.rand(TRAIN_B, 3, TRAIN_SIZE, TRAIN_SIZE, device=device,
                     generator=torch.Generator(device=device).manual_seed(14))
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: zoo_percep(loss32, big, big.flip(-1)), 3)
    return {"ms_fwd_bwd_512": ms, "peak_gb_512": torch.cuda.max_memory_allocated() / 1e9}


def zoo_cli(device: str) -> dict:
    """(d) ZOO_CLI_STEPS mini-steps of the StableSR-SSL training CLI with
    ``model.use_flash_attention=true sslopt.simself_strategy=ZOO_CLI_STRATEGY``
    as overrides, at the full width of ssl_base.yml on fresh
    ``diffusion_cli_fixtures`` data (no checkpoint or preview falls in the
    run; TRAIN_MINI_STEPS mini-steps an update): losses finite and
    l_selfsim > 0 at every mini-step, the weights moved after every
    TRAIN_MINI_STEPS-th only, per mini-step K2 TRAIN_K2_FWD forward and
    TRAIN_K2_BWD backward launches (diffusion_cli's) and no K1 (the zoo
    replaces the fused loss), every float32 K2 kernel launched; ms per
    mini-step, peak memory and the edge pixels per image (mask stride 3)
    against the capacity."""
    import tempfile
    import types

    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion import main as dmain
    from ssl_tpu_torch.diffusion.ddpm_ssl import StableSRSSL, trainable
    from ssl_tpu_torch.losses import simself_strategies
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import apply_mask_stride

    per_step_expected = {"k1": 0, "k2_fwd": TRAIN_K2_FWD, "k2_bwd": TRAIN_K2_BWD}
    with tempfile.TemporaryDirectory(prefix="zoo_smoke_") as root:
        d, _ = diffusion_cli_fixtures(os.path.join(root, "data"), device)
        cfg = ssl_base_train_cfg(d)
        cfg["train"].update(max_steps=ZOO_CLI_STEPS, save_every=1000, image_every=1000)
        cfg_path = os.path.join(root, "ssl_base.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        records, steps, edges, live = [], [], [], {}
        call, loss_fn = StableSRSSL.train_step, simself_strategies.simself_strategy_loss

        def counts():
            return {"k1": ssg_cuda.launches, **k2_counts()}

        def step(self, state, batch, draws=None):
            if "start" not in live:
                live["start"] = [p.detach().clone() for p in trainable(state.params)]
            before = counts()
            out = call(self, state, batch, draws)
            steps.append({k: v - before[k] for k, v in counts().items()})
            return out

        def strategy_loss(sr, gt, mask, setting):
            m = apply_mask_stride(mask[:, 0] if mask.dim() == 4 else mask, setting.mask_stride)
            edges.append([int(v) for v in m.reshape(m.shape[0], -1).sum(1)])
            live["setting"] = setting
            return loss_fn(sr, gt, mask, setting)

        def on_iteration(record, state, degrader):
            moved = not all(torch.equal(a, p) for a, p in zip(live["start"],
                                                               trainable(state.params)))
            if moved:
                live["start"] = [p.detach().clone() for p in trainable(state.params)]
            records.append(dict(record, moved=moved))

        ssg_cuda.launches = 0
        reset_k2_counts()
        StableSRSSL.train_step = step
        simself_strategies.simself_strategy_loss = strategy_loss
        args = types.SimpleNamespace(
            base=cfg_path, logdir=os.path.join(root, "logs"), device=device, resume=None,
            overrides=["model.use_flash_attention=true",
                       f"sslopt.simself_strategy={ZOO_CLI_STRATEGY}"])
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            dmain.train(args, on_iteration)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            StableSRSSL.train_step = call
            simself_strategies.simself_strategy_loss = loss_fn
        kernels = k2_counts()
    if live.get("setting") is None or live["setting"].strategy != ZOO_CLI_STRATEGY:
        fail(f"zoo: the CLI's SSL term did not go through {ZOO_CLI_STRATEGY}")
    if [r["step"] for r in records] != list(range(1, ZOO_CLI_STEPS + 1)):
        fail(f"zoo: the CLI ran mini-steps {[r['step'] for r in records]}")
    for r in records:
        if not all(np.isfinite(v) for v in r["logs"].values()) or r["logs"]["l_selfsim"] <= 0:
            fail(f"zoo: CLI mini-step {r['step']} logged {r['logs']}")
        if r["moved"] != (r["step"] % TRAIN_MINI_STEPS == 0):
            fail(f"zoo: after CLI mini-step {r['step']} the weights "
                 f"{'moved' if r['moved'] else 'did not move'}")
    if any({k: s_[k] for k in per_step_expected} != per_step_expected for s_ in steps):
        fail(f"zoo: CLI launches per mini-step {steps}, expected {per_step_expected}")
    idle = [k for k, c in kernels.items() if c == 0 and k.startswith("flash_attn")
            and not k.endswith("_bf16")]
    if idle:
        fail(f"zoo: the CLI's K2 kernels {idle} never launched: {kernels}")
    warm = [r["iter_s"] for r in records[1:] if not r["moved"]]
    applying = [r["iter_s"] for r in records if r["moved"]]
    flat = [e for batch in edges for e in batch]
    return {"strategy": ZOO_CLI_STRATEGY, "mini_steps": ZOO_CLI_STEPS,
            "accumulate": TRAIN_MINI_STEPS,
            "reduced": {"accumulate_grad_batches": [SHIPPED_ACCUMULATE, TRAIN_MINI_STEPS]},
            "wall_s": wall,
            "ms_first": 1e3 * records[0]["iter_s"], "ms_warm_mean": 1e3 * sum(warm) / len(warm),
            "ms_applying": 1e3 * sum(applying) / len(applying),
            "degrader_ms_mean": 1e3 * sum(r["degrade_s"] for r in records) / len(records),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "capacity": live["setting"].capacity,
            "edges_per_image": {"min": min(flat), "mean": sum(flat) / len(flat), "max": max(flat),
                                "over_capacity": sum(e > live["setting"].capacity
                                                     for e in flat), "images": len(flat)},
            "losses_last": records[-1]["logs"], "launches_per_mini_step": per_step_expected,
            "launches": {k: v for k, v in kernels.items() if not k.endswith("_bf16")}}


def zoo_cases():
    """The zoo phase's inputs: the ESRGAN-SSL step's shape with its gather
    setting, the held cases (``kl_softmax`` on the first ZOO_B pictures of
    that shape, then every loss key of the zoo, the masked families first:
    their references take the longest) and PerceptualSimLoss's pair."""
    import numpy as np
    from ssl_tpu_torch.losses.ssl_loss import SSLSetting, ssl_setting_from_opt
    from torch_zoo_cases import LOSS_KEYS, loss_opts

    main = edge_case(MAIN_B, MAIN_GT, 11)
    gather = ssl_setting_from_opt(shipped_opt(MAIN_B))._replace(
        impl="scan", capacity=int(main[2].reshape(MAIN_B, -1).sum(1).max()))
    zoo = edge_case(ZOO_B, ZOO_SIZE, 12)
    cases = {"kl_softmax": (tuple(a[:ZOO_B] for a in main), gather._replace(kl_softmax=True))}
    cases.update((key, (zoo, SSLSetting(strategy=key, strategy_opts=loss_opts(key, scaled=True),
                                        mask_stride=3, capacity=ZOO_CAP, l1_weight=0.5,
                                        kl_weight=0.5)))
                 for key in sorted(LOSS_KEYS, key=lambda k: "mask" not in k))
    rng = np.random.RandomState(13)
    percep_in = tuple(rng.rand(ZOO_B, 3, ZOO_SIZE, ZOO_SIZE) for _ in range(2))
    return main, gather, cases, percep_in


def zoo_start_refs():
    """Start the zoo phase's CPU float64 references in ZOO_REF_WORKERS
    spawned processes of ZOO_REF_THREADS threads.  main() starts them
    before the build, so that they run on the host's idle cores beside the
    card's earlier phases.  Returns (the pool, the futures by case, the
    PerceptualSimLoss future, ``zoo_cases()``): the cases are made once,
    with TF32 off as the zoo phase runs, and shared with it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        inputs = zoo_cases()
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved
    _, _, cases, percep_in = inputs
    pool = ProcessPoolExecutor(ZOO_REF_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    STOP.append(lambda: stop_pool(pool))
    refs = {key: pool.submit(zoo_cpu_ref, "loss", *args, setting)
            for key, (args, setting) in cases.items()}
    return pool, refs, pool.submit(zoo_cpu_ref, "percep", *percep_in), inputs


def stop_pool(pool) -> None:
    """Cancel what ``pool`` has not started and end its processes."""
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)


def phase_zoo(started, device: str = "cuda"):
    """The gather API, the strategy zoo and PerceptualSimLoss (ZOO_* above),
    TF32 off, against the CPU's float64 references that ``zoo_start_refs``
    started (``started``); the times are taken after those processes have
    stopped, on an idle host.  Returns the zoo CLI's K2 launches by
    kernel."""
    import torch

    t, t0 = {}, time.perf_counter()
    pool, refs, percep_ref, (main, gather, cases, percep_in) = started
    holds = zoo_f64_holds(device, cases, refs)
    percep = zoo_percep_holds(device, percep_in, percep_ref)
    pool.shutdown()
    t["f64_holds_s"] = time.perf_counter() - t0
    gather = zoo_gather_holds(device, main, gather)
    zoo_f32_times(device, cases, holds)
    percep.update(zoo_percep_times(device))
    t["times_s"] = time.perf_counter() - t0 - sum(t.values())
    torch.cuda.empty_cache()
    cli = zoo_cli(device)
    t["cli_s"] = time.perf_counter() - t0 - sum(t.values())
    readings = holds["readings"]
    emit({"phase": "zoo", "gather": dict(gather, kl_softmax=readings.pop("kl_softmax")),
          "strategies": readings, "perceptual_sim": percep, "cli": cli, "seconds": t,
          "cpu_reference_workers": [ZOO_REF_WORKERS, ZOO_REF_THREADS],
          "cpu_references_started": "before the build, beside the earlier phases",
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    return cli["launches"]


def realesrgan_host_run(root: str, opt: dict, device: str) -> tuple[dict, int]:
    """RE_HOST_ITERS iterations of the RealESRGAN-SSL train CLI with
    ``degradation_device: false`` on the ``realesrgan`` phase's data: each
    batch of RE_B is degraded on the host (``prepare_batch``: the host C++
    and numpy), cropped to ``gt_size`` (device mode never crops: ROADMAP.md
    section 3) and passed through the host pool of RE_QUEUE pairs (pointer
    RE_B, RE_QUEUE, RE_QUEUE: the third iteration takes the full branch);
    then the training state reloaded into a fresh model, its host state (the
    degrader's two streams and the pool, ``save_degradation_pool``) bit for
    bit.  Returns the result and the K1 launches."""
    import gc

    import numpy as np
    import torch
    import ssl_tpu_torch.train as train_cli
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.realesrganssl_model import RealESRGANSSLModel
    from ssl_tpu_torch.ops import ssg_cuda

    hopt = dict(opt, name="RealESRGANSSL_x4_host", degradation_device=False,
                save_degradation_pool=True)
    hopt["train"] = dict(opt["train"], total_iter=RE_HOST_ITERS)
    path = os.path.join(root, "train_realesrgan_host.json")
    with open(path, "w") as f:
        json.dump(hopt, f)
    gt_size = hopt["datasets"]["train"]["gt_size"]
    ptrs, logs, live = [], [], {}
    step_call = RealESRGANSSLModel.train_step

    def step(self, state, batch, draws=None):
        out = step_call(self, state, batch, draws)
        ptrs.append(self.degrader.pool.ptr)
        logs.append({k: float(v) for k, v in out[1].items()})
        live["model"] = self
        return out
    spy = Spy(RealESRGANSSLModel, ["prepare_batch"], device)
    RealESRGANSSLModel.train_step = step
    try:
        ssg_cuda.launches = 0
        t0 = time.perf_counter()
        state = train_cli.train_pipeline(root, ["-opt", path]
                                         + (["--device", device] if device != "cuda" else []))
        wall = time.perf_counter() - t0
        launches = ssg_cuda.launches
    finally:
        spy.restore()
        del RealESRGANSSLModel.train_step                 # the mixin's again
    gc.collect()
    prepared = spy.calls["prepare_batch"]
    if launches != RE_HOST_ITERS or len(prepared) != RE_HOST_ITERS:
        fail(f"realesrgan host mode: K1 launched {launches} times, {len(prepared)} batches "
             f"prepared in {RE_HOST_ITERS} iterations")
    if ptrs != [min(RE_B * (i + 1), RE_QUEUE) for i in range(RE_HOST_ITERS)]:
        fail(f"realesrgan host mode: the host pool's pointer read {ptrs}")
    shapes = {k: tuple(v.shape) for k, v in prepared[-1][1].items()}
    if shapes != {"gt": (RE_B, 3, gt_size, gt_size), "gt_mask": (RE_B, 1, gt_size, gt_size),
                  "lq": (RE_B, 3, gt_size // SCALE, gt_size // SCALE)}:
        fail(f"realesrgan host mode: prepared batch {shapes}")
    for x in logs:
        if not all(np.isfinite(v) for v in x.values()):
            fail(f"realesrgan host mode: losses {x}")
    exp = os.path.join(root, "experiments", hopt["name"], "training_states")
    fresh = build_model(dict(hopt, is_train=True), device=device)
    fresh.load_training_state(fresh.init_state(seed=1), exp, RE_HOST_ITERS)
    want, got = live["model"].host_state(), fresh.host_state()
    same = (torch.equal(want["np_rng"][1], got["np_rng"][1])
            and want["np_rng"][2:] == got["np_rng"][2:] and want["py_rng"] == got["py_rng"]
            and want["pool_ptr"] == got["pool_ptr"] == RE_QUEUE
            and sorted(want["pool_buffers"]) == sorted(got["pool_buffers"])
            and all(torch.equal(v, got["pool_buffers"][k])
                    for k, v in want["pool_buffers"].items()))
    if not same:
        fail("realesrgan host mode: the reloaded host state (streams, pool) differs")
    del fresh, state, live
    gc.collect()
    torch.cuda.empty_cache()
    return {"iterations": RE_HOST_ITERS, "batch": RE_B, "gt_size": gt_size,
            "queue_size": RE_QUEUE, "pool_ptr_by_iter": ptrs, "prepared_shapes": shapes,
            "host_degrader_ms_per_iter": [1e3 * t for t, _ in prepared],
            "losses_last_iter": logs[-1], "wall_s": wall, "k1_launches": launches,
            "pool_pairs_bit_for_bit": len(want["pool_buffers"])}, launches


def write_png(img, path: str) -> None:
    """A (3, h, w) RGB tensor of uint8 values as a BGR PNG through ``utils/png.py``."""
    from ssl_tpu_torch.utils.png import encode_png
    with open(path, "wb") as f:
        f.write(encode_png(img.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]))


def read_png(path: str):
    import numpy as np
    from ssl_tpu_torch.utils.png import decode_png
    with open(path, "rb") as f:
        return decode_png(f.read(), "unchanged").astype(np.int64)


def levels_off(a, b) -> dict:
    """Two uint8 images: the largest difference in levels and the share of
    values that differ."""
    import numpy as np
    if a.shape != b.shape:
        fail(f"prep_infer: shapes {a.shape} and {b.shape} differ")
    d = np.abs(a - b)
    return {"max_levels": int(d.max()), "share": float((d > 0).mean())}


def subset(src: str, dst: str, names) -> str:
    """``dst`` holding copies of ``src``'s files ``names``."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    for name in names:
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return dst


def prep_train_opt(d: dict, mask_dir: str) -> dict:
    """The shipped ESRGAN-SSL YAML's values (``shipped_opt``) on the files
    the data-preparation entry points wrote: PI_ITERS iterations, a log line
    each and a checkpoint at the last; no validation set."""
    opt = shipped_opt(MAIN_B)
    opt["name"] = "prep_infer_ESRGANSSL"
    opt["datasets"] = {"train": {
        "name": "prep_infer", "type": "PairedImageMaskDataset", "dataroot_gt": d["gt"],
        "dataroot_lq": d["lr"], "dataroot_gt_mask": mask_dir, "filename_tmpl": "{}",
        "io_backend": {"type": "disk"}, "gt_size": MAIN_GT, "use_hflip": True, "use_rot": True,
        "num_worker_per_gpu": CLI_WORKERS, "batch_size_per_gpu": MAIN_B,
        "dataset_enlarge_ratio": CLI_ENLARGE}}
    opt["path"]["resume_state"] = None
    opt["train"]["total_iter"] = PI_ITERS
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": PI_ITERS, "use_tb_logger": False}
    return opt


class image_times:
    """The wall clock at the end of each image file an inference entry point
    writes while the block runs (its ``imwrite``, after the image is on the
    host): ``record(t0)`` gives the first image's ms from ``t0`` (the net's
    build and load included) and the mean ms per image after it."""

    def __enter__(self):
        from ssl_tpu_torch.scripts.inference import common
        from ssl_tpu_torch.utils import img_util
        self.targets, self.stamps = (common, img_util), []
        self.saved = [m.imwrite for m in self.targets]

        def stamped(*a, _f=img_util.imwrite, **kw):
            out = _f(*a, **kw)
            self.stamps.append(time.perf_counter())
            return out
        for m in self.targets:
            m.imwrite = stamped
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.targets, self.saved):
            m.imwrite = f

    def record(self, t0: float) -> dict:
        st = self.stamps
        return {"images": len(st), "first_image_ms": 1e3 * (st[0] - t0),
                "ms_per_image": 1e3 * (st[-1] - st[0]) / (len(st) - 1) if len(st) > 1 else None}


def run_entry(main, argv: list, device: str) -> dict:
    """One inference entry point run on ``device``: its times per image and
    peak device memory."""
    import torch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with image_times() as times:
        main(argv)
    rec = times.record(t0)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
    return rec


def registry_hold(device: str) -> dict:
    """Each arch of PI_REGISTRY at its default width from a seeded init,
    forward and backward (train mode: batch statistics, power iterations) on
    ``device`` and on the CPU from the same weights and input, TF32 off: the
    output, the input's gradient and all parameters' gradients in relative L2
    against the CPU in float64.  In float64 the card holds within
    PI_REG_F64.  In float32 the output holds within PI_REG_REL_L2; the
    gradients are reported beside the CPU float32's own: where a
    pre-activation lies within rounding of 0, the two sides take the other
    slope of the leaky ReLU, and one such element moves a gradient by ~1e-4
    in relative L2 (on an H100: 2.6e-4 at UNetDiscriminatorSNv1's conv3
    from one kink, against 3e-7 with none).  Also the card's ms for a
    float32 forward and backward."""
    import copy
    import torch
    from ssl_tpu_torch.metrics.metric_util import exact_float32
    from ssl_tpu_torch.utils.registry import build_network
    out = {}
    keys = ("output", "input_grad", "param_grads")
    for i, (name, shape) in enumerate(PI_REGISTRY.items()):
        net = build_network({"type": name})
        net.reset_parameters(torch.Generator().manual_seed(i))
        x = torch.rand(shape, generator=torch.Generator().manual_seed(100 + i))

        def run(dev, dtype=torch.float32):
            m = copy.deepcopy(net).to(dev, dtype).train()
            xi = x.detach().to(dev, dtype).clone().requires_grad_(True)
            y = m(xi)
            if name == "MOD":                             # logits and the routing softmax
                loss = y[0].sum() + (y[1] ** 2).sum()
                y = y[0]
            else:
                loss = y.sum()
            loss.backward()
            grads = torch.cat([p.grad.flatten() for p in m.parameters()])
            return y.detach().cpu(), xi.grad.cpu(), grads.cpu(), (m, xi)

        with exact_float32():
            want = run("cpu", torch.float64)
            err = {side: {k: rel_l2(g, w) for k, g, w in zip(keys, got[:3], want[:3])}
                   for side, got in (("card_float64", run(device, torch.float64)),
                                     ("cpu_float32", run("cpu")))}
            card = run(device)
            err["card_float32"] = {k: rel_l2(g, w) for k, g, w in zip(keys, card[:3], want[:3])}
            m, xi = card[3]

            def step():
                xi.grad = None
                y = m(xi)
                (y[0].sum() if name == "MOD" else y.sum()).backward()
            ms = time_ms(step, 3) if device == "cuda" else None
        if max(err["card_float64"].values()) > PI_REG_F64 or \
                err["card_float32"]["output"] > PI_REG_REL_L2:
            fail(f"prep_infer: registry hold {name}: {err} (bounds {PI_REG_F64} in float64, "
                 f"{PI_REG_REL_L2} on the float32 output)")
        out[name] = {"shape": list(shape), "rel_l2_to_cpu_float64": err, "fwd_bwd_ms": ms,
                     "params": sum(p.numel() for p in net.parameters())}
    return out


def phase_prep_infer(device: str = "cuda"):
    """From HR images to SR images with the port alone, through the entry
    points a user calls: generate_bicubic_lr, generate_mask, the ESRGAN-SSL
    train CLI (K1 once per iteration), inference_ssl_sr whole and tiled,
    inference_rrdbnet, inference_swinir, back_projection and
    generate_realesrgan_bsrgan_lr; each entry point's first image held
    against its CPU run, inference_ssl_sr's SR against the test CLI's; the
    DIV2K-valid size's times; the registry hold.  Returns K1's launches."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    from ssl_tpu_torch.metrics.metric_util import exact_float32
    from ssl_tpu_torch.scripts import (back_projection, generate_bicubic_lr,
                                       generate_realesrgan_bsrgan_lr)
    from ssl_tpu_torch.scripts.inference import (inference_rrdbnet, inference_ssl_sr,
                                                 inference_swinir)
    from ssl_tpu_torch.utils.registry import build_network

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    dev = ["--device", device] if device != "cuda" else []   # the entry points default to the card
    sections, last = {}, [time.perf_counter()]

    def mark(name):
        """The seconds since the previous mark, kept under ``name``."""
        now = time.perf_counter()
        sections[name] = now - last[0]
        last[0] = now

    with tempfile.TemporaryDirectory(prefix="prep_infer_") as root:
        d = {k: os.path.join(root, k) for k in ("hr", "gt", "lr", "masks", "div2k_hr",
                                                "div2k_gt", "div2k_lr", "gen_lr", "gen_sr", "bp")}
        os.makedirs(d["hr"])
        gen = torch.Generator(device=device).manual_seed(19)
        t0 = time.perf_counter()
        for i in range(PI_HR):
            write_png(smooth_picture(*PI_HR_SIZE, gen, device), os.path.join(d["hr"], f"{i:04d}.png"))
        fixtures_s = time.perf_counter() - t0
        names = sorted(os.listdir(d["hr"]))
        mark("fixtures")

        # data preparation
        prep_s = {}
        _, prep_s["generate_bicubic_lr"] = timed(generate_bicubic_lr.main, [
            "--input", d["hr"], "--output", d["lr"], "--mod", "12", "--gt_output", d["gt"]])
        gt_hw = tuple(n - n % 12 for n in PI_HR_SIZE)
        lr_hw = tuple(n // SCALE for n in gt_hw)
        lr0 = read_png(os.path.join(d["lr"], names[0]))
        if lr0.shape != lr_hw + (3,) or \
                read_png(os.path.join(d["gt"], names[0])).shape != gt_hw + (3,):
            fail(f"prep_infer: LR {lr0.shape} from {PI_HR_SIZE} HR")
        (mask_dir, edge_share), prep_s["generate_mask"] = timed(generate_masks, d["gt"], d["masks"])
        mark("data_preparation")

        # the train CLI at the shipped widths on those files
        opt = prep_train_opt(d, mask_dir)
        opt_path = os.path.join(root, "prep_train.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state, logged, launches, train_wall = run_train_cli(root, ["-opt", opt_path] + dev, device)
        train_peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        del state
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        if launches != PI_ITERS:
            fail(f"prep_infer: K1 launched {launches} times in {PI_ITERS} iterations")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        for x in logged:
            if not all(np.isfinite(x.get(k, np.nan)) for k in loss_keys):
                fail(f"prep_infer: iteration {x['iter']}: losses {x}")
        model_path = os.path.join(root, "experiments", opt["name"], "models",
                                  f"net_g_{PI_ITERS}.pth")
        if not os.path.isfile(model_path):
            fail(f"prep_infer: {model_path} was not written")
        mark("train_cli")

        # the inference entry points on the first PI_INFER LR images
        lq = subset(d["lr"], os.path.join(root, "lq"), names[:PI_INFER])
        one = subset(d["lr"], os.path.join(root, "lq_one"), names[:1])
        tile = ["--tile_size", str(PI_TILE[0]), "--tile_pad", str(PI_TILE[1])]
        swin_path = os.path.join(root, "swinir_seeded.pth")
        swin = build_network({"type": "SwinIR", "upscale": SCALE, **PI_SWINIR})
        swin.reset_parameters(torch.Generator().manual_seed(0))
        torch.save({"params_ema": swin.state_dict()}, swin_path)
        del swin
        entries = {
            "inference_ssl_sr": (inference_ssl_sr.main, ["--model_path", model_path]),
            "inference_ssl_sr_tiled": (inference_ssl_sr.main, ["--model_path", model_path] + tile),
            "inference_rrdbnet": (inference_rrdbnet.main, ["--model_path", model_path]),
            "inference_swinir": (inference_swinir.main, [
                "--model_path", swin_path, "--net_opt", json.dumps(PI_SWINIR)]),
        }
        runs, holds, cpu_s = {}, {}, 0.0
        for label, (main_fn, extra) in entries.items():
            out_dir = os.path.join(root, f"sr_{label}")
            runs[label] = run_entry(main_fn, ["--input", lq, "--output", out_dir] + extra + dev,
                                    device)
            sr = read_png(os.path.join(out_dir, sorted(os.listdir(out_dir))[0]))
            if sr.shape != gt_hw + (3,) or sr.std() < 1:
                fail(f"prep_infer: {label}'s SR {sr.shape}, std {sr.std()}")
            if label == "inference_swinir":
                continue
            # the first image: the card with TF32 off against --device cpu
            got = {}
            for side, flags in (("card", dev), ("cpu", ["--device", "cpu"])):
                side_dir = os.path.join(root, f"one_{label}_{side}")
                t0 = time.perf_counter()
                with exact_float32():
                    main_fn(["--input", one, "--output", side_dir] + extra + flags)
                cpu_s += time.perf_counter() - t0 if side == "cpu" else 0.0
                got[side] = read_png(os.path.join(side_dir, sorted(os.listdir(side_dir))[0]))
            holds[label] = levels_off(got["card"], got["cpu"])
            if holds[label]["max_levels"] > 1 or holds[label]["share"] > PI_LEVEL_SHARE:
                fail(f"prep_infer: {label} on the card against the CPU: {holds[label]}")
            if label == "inference_ssl_sr":
                ssl_sr_card = got["card"]
        mark("inference_and_holds")

        # inference_ssl_sr's SR against the test CLI's, both TF32 off
        test_opt = {"name": "prep_infer_test", "model_type": "ESRGANSSLModel", "scale": SCALE,
                    "num_devices": 1, "manual_seed": 0,
                    "datasets": {"test_1": {"name": "prep_one", "type": "PairedImageDataset",
                                            "dataroot_gt": subset(d["gt"], os.path.join(
                                                root, "gt_one"), names[:1]),
                                            "dataroot_lq": one, "io_backend": {"type": "disk"}}},
                    "network_g": opt["network_g"],
                    "path": {"pretrain_network_g": model_path, "param_key_g": "params_ema"},
                    "val": {"save_img": True, "metrics": CLI_METRICS}}
        test_path = os.path.join(root, "prep_test.json")
        with open(test_path, "w") as f:
            json.dump(test_opt, f)
        with exact_float32():
            test_metrics = test_cli.test_pipeline(root, ["-opt", test_path] + dev)["prep_one"]
        vis = os.path.join(root, "results", "prep_infer_test", "visualization", "prep_one")
        holds["ssl_sr_vs_test_cli"] = levels_off(
            read_png(os.path.join(vis, sorted(os.listdir(vis))[0])), ssl_sr_card)
        if holds["ssl_sr_vs_test_cli"]["max_levels"] > 1:
            fail(f"prep_infer: inference_ssl_sr against the test CLI: "
                 f"{holds['ssl_sr_vs_test_cli']}")
        mark("test_cli")

        # back_projection on PI_GEN of the SR, and generate_realesrgan_bsrgan_lr
        sr_dir = os.path.join(root, "sr_inference_ssl_sr")
        (bp_names, prep_s["back_projection"]) = timed(back_projection.main, [
            "--lr", subset(d["lr"], os.path.join(root, "lr_bp"), names[:PI_GEN]),
            "--pre", subset(sr_dir, os.path.join(root, "sr_bp"), names[:PI_GEN]),
            "--out", d["bp"]])
        gen_opt = dict(GENERATE_OPT, datasets={"prep": {"dataroot": subset(
            d["hr"], os.path.join(root, "hr_gen"), names[:PI_GEN])}})
        gen_path = os.path.join(root, "generate.json")
        with open(gen_path, "w") as f:
            json.dump(gen_opt, f)
        branches, prep_s["generate_realesrgan_bsrgan_lr"] = timed(
            generate_realesrgan_bsrgan_lr.main, ["--param_path", gen_path, "--save_LR_path",
                                                 d["gen_lr"], "--save_bicubicSR_path", d["gen_sr"]])
        for name, _ in branches:
            base = os.path.splitext(name)[0] + ".png"
            if read_png(os.path.join(d["gen_sr"], base)).shape != tuple(PI_HR_SIZE) + (3,):
                fail(f"prep_infer: the bicubic SR of {name}")
        mark("back_projection_and_generate")

        # one DIV2K-valid image (twice, for a steady-state time per image)
        os.makedirs(d["div2k_hr"])
        write_png(smooth_picture(*PI_DIV2K, gen, device), os.path.join(d["div2k_hr"], "a.png"))
        _, prep_s["generate_bicubic_lr_div2k"] = timed(generate_bicubic_lr.main, [
            "--input", d["div2k_hr"], "--output", d["div2k_lr"], "--mod", "12", "--gt_output",
            d["div2k_gt"]])
        with open(os.path.join(d["div2k_lr"], "a.png"), "rb") as f:   # for the parallel phase
            PI_STASH["div2k_lr_png"] = f.read()
        import shutil
        shutil.copy(os.path.join(d["div2k_lr"], "a.png"), os.path.join(d["div2k_lr"], "b.png"))
        div2k = {}
        for label, (main_fn, extra) in entries.items():
            out_dir = os.path.join(root, f"div2k_{label}")
            div2k[label] = run_entry(main_fn, ["--input", d["div2k_lr"], "--output", out_dir]
                                     + extra + dev, device)
            if read_png(os.path.join(out_dir, sorted(os.listdir(out_dir))[0])).shape != \
                    tuple(n - n % 12 for n in PI_DIV2K) + (3,):
                fail(f"prep_infer: {label} at the DIV2K size")
        mark("div2k")
        registry = registry_hold(device)
        mark("registry")

    per_image = {"generate_bicubic_lr": PI_HR, "generate_mask": PI_HR,
                 "back_projection": PI_GEN, "generate_realesrgan_bsrgan_lr": PI_GEN,
                 "generate_bicubic_lr_div2k": 1}
    result = {
        "phase": "prep_infer", "hr_images": PI_HR, "hr_size": list(PI_HR_SIZE),
        "lr_size": list(lr_hw), "fixtures_s": fixtures_s,
        "prep_ms_per_image": {k: 1e3 * prep_s[k] / n for k, n in per_image.items()},
        "edge_share": edge_share, "decoder": decoder(),
        "train": {"iterations": PI_ITERS, "k1_launches": launches, "wall_s": train_wall,
                  "iter_ms": [1e3 * x["time"] for x in logged], "peak_mem_gb": train_peak,
                  "losses_last_iter": {k: logged[-1][k] for k in loss_keys}},
        "inference": runs, "inference_div2k": div2k,
        "div2k_lr": [(n - n % 12) // SCALE for n in PI_DIV2K],
        "tile": list(PI_TILE), "holds": holds, "test_cli_metrics": test_metrics,
        "realesrgan_bsrgan_branches": [t for _, t in branches],
        "back_projection_images": len(bp_names), "registry": registry,
        "tf32": "entry point runs timed at cuDNN TF32 on (torch's default); holds with TF32 off",
        "seconds": sections, "cpu_hold_runs_s": cpu_s,
        "card": card() if device == "cuda" else None}
    emit(result)
    return launches


class parallel_env:
    """torchrun's environment for one rank on this machine (a free port on
    localhost) while the block runs; the earlier values come back after it."""
    KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

    def __enter__(self):
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0")

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class deterministic_float32:
    """cuDNN's deterministic algorithms, and no TF32, while the block runs:
    two runs of one step then differ only where their arithmetic does."""

    def __enter__(self):
        import torch
        b = torch.backends
        self.saved = (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
                      b.cuda.matmul.allow_tf32)
        b.cudnn.deterministic, b.cudnn.benchmark = True, False
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        b = torch.backends
        (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_tf32) = self.saved


def grad_floors(counts: dict):
    """A spy on the GAN recipes' ``optimizer_step`` that counts, for every
    element of each net's parameters, the steps at which its gradient was
    below PAR_GRAD_FLOOR of the net's largest (rounding noise: Adam's first
    steps move such an element by about lr either way).  Restore it with
    ``.restore()``."""
    import torch
    from ssl_tpu_torch.models import srgan_model

    orig = srgan_model.optimizer_step

    def spy(opt, lr, apply=True):
        params = [p for g in opt.param_groups for p in g["params"]]
        grads = [p.grad for p in params if p.grad is not None]
        if apply and grads:
            top = max(float(g.abs().max()) for g in grads)
            for p in params:
                if p.grad is not None:
                    c = counts.setdefault(id(p), torch.zeros_like(p, dtype=torch.int32))
                    c += (p.grad.abs() < PAR_GRAD_FLOOR * top).int()
        return orig(opt, lr, apply)

    class Restore:
        def restore(self):
            srgan_model.optimizer_step = orig
    srgan_model.optimizer_step = spy
    return Restore()


def start_dist_train(device: str = "cuda") -> dict:
    """Start (b) of ``phase_parallel``: ``ssl_tpu_torch/scripts/dist_train.sh``
    (torchrun --standalone, one rank) for PAR_TORCHRUN_ITERS iterations on
    ``cli_fixtures`` data with a small G and D (RRDBNet 8/1/4, D 4, no
    perceptual term: this checks the launch path; (a) holds the widths'
    step), in its own temporary directory.  main() starts it before the
    prep_infer phase, so that its start-up runs beside that phase;
    ``phase_parallel`` waits for it and checks what it wrote.  Returns its
    process, folder, log and start time."""
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix="parallel_torchrun_")
    t0 = time.perf_counter()
    d, _ = cli_fixtures(os.path.join(tmp.name, "data"), device)
    opt = cli_opt(d, MAIN_B)
    opt["name"] = "parallel_torchrun"
    opt["train"]["total_iter"] = PAR_TORCHRUN_ITERS
    opt["val"]["val_freq"] = None
    opt["logger"]["save_checkpoint_freq"] = None
    opt["network_g"].update(num_feat=8, num_block=1, num_grow_ch=4)
    opt["network_d"]["num_feat"] = 4
    del opt["train"]["perceptual_opt"]
    path = os.path.join(tmp.name, "torchrun.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    env = {k: v for k, v in os.environ.items() if k not in parallel_env.KEYS}
    log = open(os.path.join(tmp.name, "torchrun.log"), "w")
    proc = subprocess.Popen(
        ["bash", os.path.join(ROOT, "ssl_tpu_torch", "scripts", "dist_train.sh"), "1", path],
        cwd=tmp.name, env=env, stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        tmp.cleanup()
    STOP.append(stop)
    return {"proc": proc, "root": tmp.name, "log": log, "t0": t0, "stop": stop}


def phase_parallel(started: dict, device: str = "cuda"):
    """The port's torch.distributed paths at one rank under NCCL, at full
    width:

    (a) the ESRGAN-SSL train CLI (cli_opt: RRDBNet 23 x 64, the VGG-style D
        with its synced batch norm, batch 16, GT 128) for PAR_ITERS
        iterations with ``--launcher none`` and with ``--launcher pytorch``
        (DDP), in this process, then ``--auto_resume`` to PAR_RESUME_ITERS
        under pytorch, all with cuDNN deterministic and TF32 off
        (``deterministic_float32``): each iteration's losses within rtol 1e-4 of the
        none run's, the weights within lr / 5 (plus 2.2 lr for each step
        at which an element's gradient was below PAR_GRAD_FLOOR of its
        net's largest; the share of such elements and of those beyond lr / 5
        are reported), K1 once per iteration, and net_g's file without a ``module.`` prefix loading
        into the plain net; ms per iteration of both, in turns (none,
        pytorch, pytorch, none), with nothing else on the card;
    (b) one ``ssl_tpu_torch/scripts/dist_train.sh`` (``start_dist_train``,
        ``started``: torchrun --standalone, one rank) of PAR_TORCHRUN_ITERS
        iterations at small widths, which must exit with 0 and leave rank
        0's files; it starts before the prep_infer phase and has ended
        before (a)'s timed turns as a rule (else they wait for it);
    (c) ``inference_ssl_sr --spatial`` on the prep_infer phase's DIV2K-size
        LR, equal to the net applied to the whole image;
    (d) two StableSR-SSL mini-steps (ssl_base.yml's widths with
        ``num_res_blocks`` 1, 256^2, batch 2, accumulate 2) with
        ``parallel: {data: 1, tp: 1}`` against the same mini-steps without a
        mesh: losses within TRAIN_LOG_RTOL, the first mini-step's summed
        gradients within TRAIN_GRAD_REL_L2, the update within 2.2 lr per
        element; K1 and K2 launched.

    Returns the launches by path: K1's of (a) and (d), K2's kernels' of (d)."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import load_network
    from ssl_tpu_torch.parallel.fsdp import unwrap
    from ssl_tpu_torch.scripts.inference import inference_ssl_sr

    secs = {}
    with tempfile.TemporaryDirectory(prefix="parallel_smoke_") as root:
        t0 = time.perf_counter()
        d, _ = cli_fixtures(os.path.join(root, "data"), device)
        paths = {}
        # validation in the pytorch run only (rank 0 scores); one save, the
        # final one, in each run
        for label, iters, val in (("none", PAR_ITERS, None),
                                  ("pytorch", PAR_ITERS, PAR_ITERS),
                                  ("pytorch_2", PAR_ITERS, None),
                                  ("none_2", PAR_ITERS, None)):
            opt = cli_opt(d, MAIN_B)
            opt["name"] = f"parallel_{label}"
            opt["train"]["total_iter"] = iters
            opt["val"]["val_freq"] = val
            opt["logger"]["save_checkpoint_freq"] = None
            paths[label] = os.path.join(root, f"{label}.json")
            with open(paths[label], "w") as f:
                json.dump(opt, f)
        secs["fixtures"] = time.perf_counter() - t0

        # (b) dist_train.sh, started before the prep_infer phase: it ends
        # before (a)'s timed turns, so that they run alone on the card
        torchrun = started["proc"]
        t0 = time.perf_counter()
        try:
            torchrun.wait(timeout=PAR_TORCHRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass
        secs["torchrun_wait"] = time.perf_counter() - t0
        secs["torchrun"] = time.perf_counter() - started["t0"]
        started["log"].close()
        with open(os.path.join(started["root"], "torchrun.log")) as f:
            out = f.read()
        texp = os.path.join(started["root"], "experiments", "parallel_torchrun")
        written = sorted(os.listdir(os.path.join(texp, "models"))) if os.path.isdir(texp) else []
        if torchrun.returncode != 0 or f"net_g_{PAR_TORCHRUN_ITERS}.pth" not in written or \
                not os.path.isfile(os.path.join(texp, "training_states",
                                                f"{PAR_TORCHRUN_ITERS}.state")):
            fail(f"parallel: dist_train.sh exited {torchrun.returncode}, wrote {written}:\n"
                 f"{out[-3000:]}")
        started["stop"]()
        STOP.remove(started["stop"])

        # (a) --launcher none, then pytorch (DDP at one rank): held; then a
        # second turn of each in the other order, for the times alone
        runs, floors, times = {}, {}, {"none": [], "pytorch": []}
        for label in ("none", "pytorch", "pytorch_2", "none_2"):
            launcher = label.split("_")[0]
            args = ["--launcher", "pytorch"] if launcher == "pytorch" else []
            t0 = time.perf_counter()
            spy = grad_floors(floors) if label == "none" else None
            with parallel_env(), deterministic_float32():
                state, logged, launches, wall = run_train_cli(
                    root, ["-opt", paths[label]] + args, device, [spy] if spy else [])
            times[launcher].append({"ms_per_iter": per_iter_ms(logged, "time"),
                                    "first_iter_ms": 1e3 * logged[0]["time"], "wall_s": wall})
            if label in ("none", "pytorch"):
                nets = {n: [p.detach().clone() for p in unwrap(getattr(state, n)).parameters()]
                        for n in ("net_g", "net_d", "net_g_ema")}
                noisy = {n: [floors.get(id(p)) for p in unwrap(getattr(state, n)).parameters()]
                         for n in ("net_g", "net_d")} if label == "none" else None
                wrapped = {n: type(getattr(state, n)).__name__ for n in ("net_g", "net_d")}
                runs[label] = {"logged": logged, "launches": launches, "nets": nets,
                               "noisy": noisy, "wrapped": wrapped}
            elif launches != PAR_ITERS:
                fail(f"parallel: K1 launched {launches} times in the {label} run")
            del state
            gc.collect()
            secs[f"cli_{label}"] = time.perf_counter() - t0

        if not dist.is_initialized() or dist.get_backend() != "nccl":
            fail("parallel: --launcher pytorch left no NCCL process group")
        if runs["pytorch"]["wrapped"] != {"net_g": "DistributedDataParallel",
                                          "net_d": "DistributedDataParallel"}:
            fail(f"parallel: the nets were not wrapped in DDP: {runs['pytorch']['wrapped']}")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        loss_err = 0.0
        for a, b in zip(runs["none"]["logged"], runs["pytorch"]["logged"]):
            for k in loss_keys:
                err = abs(b[k] - a[k]) / max(abs(a[k]), 1e-30)
                loss_err = max(loss_err, err)
                if not err <= 1e-4:
                    fail(f"parallel: iteration {a['iter']} {k}: pytorch {b[k]} against none "
                         f"{a[k]}")
        lr = cli_opt(d, MAIN_B)["train"]["optim_g"]["lr"]
        weight_err, noisy_share, beyond_fifth = {}, {}, {}
        for n in ("net_g", "net_d", "net_g_ema"):
            worst, n_noisy, n_beyond, total = 0.0, 0, 0, 0
            pairs = zip(runs["none"]["nets"][n], runs["pytorch"]["nets"][n])
            for i, (a, b) in enumerate(pairs):
                cnt = runs["none"]["noisy"]["net_d" if n == "net_d" else "net_g"][i]
                cnt = torch.zeros_like(a) if cnt is None else cnt.to(a.dtype)
                tol = lr / 5 + 2.2 * lr * cnt
                diff = (a - b).abs()
                if bool((diff > tol).any()):
                    fail(f"parallel: {n} parameter {i} differs by {float(diff.max())} from the "
                         "--launcher none run")
                worst = max(worst, float(diff.max()))
                n_noisy += int((cnt > 0).sum())
                n_beyond += int((diff > lr / 5).sum())
                total += a.numel()
            weight_err[n], noisy_share[n] = worst, n_noisy / total
            beyond_fifth[n] = n_beyond / total
        for label in ("none", "pytorch"):
            if runs[label]["launches"] != PAR_ITERS:
                fail(f"parallel: K1 launched {runs[label]['launches']} times in the "
                     f"{label} run")
        exp = os.path.join(root, "experiments", "parallel_pytorch")
        g = build_model(dict(json.load(open(paths["pytorch"])), is_train=False),
                        device=device).build_g()
        sd = torch.load(os.path.join(exp, "models", f"net_g_{PAR_ITERS}.pth"),
                        map_location="cpu", weights_only=True)
        prefixed = [k for k in sd["params"] if k.startswith("module.")]
        load_network(g, os.path.join(exp, "models", f"net_g_{PAR_ITERS}.pth"))
        if prefixed or not all(torch.equal(p.cpu(), q.cpu()) for p, q in
                               zip(g.parameters(), runs["pytorch"]["nets"]["net_g"])):
            fail(f"parallel: net_g_{PAR_ITERS}.pth does not load as the plain net "
                 f"({len(prefixed)} prefixed keys)")
        t0 = time.perf_counter()
        with deterministic_float32():
            resumed, logged_r, launches_r, _ = run_train_cli(
                root, ["-opt", paths["pytorch"], "--launcher", "pytorch", "--auto_resume",
                       "--force_yml", f"train:total_iter={PAR_RESUME_ITERS}"], device)
        secs["cli_resume"] = time.perf_counter() - t0
        if [x["iter"] for x in logged_r] != list(range(PAR_ITERS + 1, PAR_RESUME_ITERS + 1)) \
                or launches_r != PAR_RESUME_ITERS - PAR_ITERS \
                or resumed.step != PAR_RESUME_ITERS:
            fail(f"parallel: the resumed run logged {[x['iter'] for x in logged_r]}, launched "
                 f"K1 {launches_r} times, ended at step {resumed.step}")
        del resumed, g
        gc.collect()
        torch.cuda.empty_cache()

        # (c) --spatial at one rank: the net on the whole image
        t0 = time.perf_counter()
        lr_dir = os.path.join(root, "div2k_lr")
        os.makedirs(lr_dir)
        with open(os.path.join(lr_dir, "a.png"), "wb") as f:
            f.write(PI_STASH["div2k_lr_png"])
        weights = os.path.join(exp, "models", f"net_g_{PAR_RESUME_ITERS}.pth")
        with parallel_env():
            spatial = run_entry(inference_ssl_sr.main,
                                ["--input", lr_dir, "--output", os.path.join(root, "sp"),
                                 "--model_path", weights, "--spatial"], device)
        from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, tensor2img
        net = build_model(dict(json.load(open(paths["pytorch"])), is_train=False),
                          device=device).build_g()
        load_network(net, weights, "params_ema")
        with torch.no_grad():
            lr_img = img2tensor(img2array(imread(os.path.join(lr_dir, "a.png"))))[None]
            whole = tensor2img(net.to(device).eval()(lr_img.to(device)), rgb2bgr=False)
        got = read_png(os.path.join(root, "sp", "a.png"))[..., ::-1]
        if got.shape != whole.shape or not np.array_equal(got, whole):
            fail(f"parallel: --spatial differs from the whole-image pass "
                 f"({got.shape} vs {whole.shape})")
        spatial_shape = list(lr_img.shape[-2:])
        del net
        secs["spatial"] = time.perf_counter() - t0

        # (d) StableSR-SSL mini-steps on the (data 1, model 1) mesh
        t0 = time.perf_counter()
        diffusion = parallel_diffusion(device)
        secs["diffusion"] = time.perf_counter() - t0
        dist.destroy_process_group()

    emit({"phase": "parallel", "world_size": 1, "backend": "nccl", "batch": MAIN_B,
          "gt_size": MAIN_GT, "iterations": PAR_ITERS, "resumed_to": PAR_RESUME_ITERS,
          "ms_per_iter": {k: [t["ms_per_iter"] for t in v] for k, v in times.items()},
          "first_iter_ms": {k: [t["first_iter_ms"] for t in v] for k, v in times.items()},
          "wall_s": {k: [t["wall_s"] for t in v] for k, v in times.items()},
          "timed_with": "float32 without TF32, cuDNN deterministic; turns none, pytorch, "
                        "pytorch, none, with nothing else on the card (dist_train.sh, started "
                        "before the prep_infer phase, has ended)",
          "k1_launches": {"none": runs["none"]["launches"],
                          "pytorch": runs["pytorch"]["launches"], "resumed": launches_r},
          "max_loss_rel_err": loss_err, "max_weight_abs_err": weight_err,
          "noisy_gradient_share": noisy_share, "share_beyond_lr_over_5": beyond_fifth,
          "torchrun": {"iterations": PAR_TORCHRUN_ITERS, "rc": torchrun.returncode,
                       "models": written},
          "spatial": {"lr_size": spatial_shape, "images": spatial["images"],
                      "peak_mem_gb": spatial["peak_mem_gb"]},
          "diffusion": diffusion,
          "seconds": secs, "card": card()})
    return {"k1": runs["pytorch"]["launches"] + launches_r + diffusion["k1_launches"],
            "k2": diffusion["k2_kernels"]}


def parallel_diffusion(device: str) -> dict:
    """(d) of ``phase_parallel``: two mini-steps of ssl_base.yml's widths
    (``num_res_blocks`` 1, accumulate 2: the second applies AdamW) with
    ``parallel: {data: 1, tp: 1}`` under the process group, and the same
    two without a mesh, from the same seeded weights and draws."""
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
    from ssl_tpu_torch.diffusion.main import build_from_config
    from ssl_tpu_torch.ops import ssg_cuda

    cfg = ssl_base_cfg()
    cfg["model"]["unet"]["num_res_blocks"] = 1
    cfg["train"]["accumulate_grad_batches"] = 2
    batch = train_batch(PAR_DIFF_SIZE, seed=30)
    out = {}
    for label, par in (("plain", None), ("mesh", {"data": 1, "tp": 1})):
        model = build_from_config(dict(cfg, parallel=par) if par else cfg)
        state = model.init_state(seed=0, device=device)
        redraw_zero_init(state)
        start = [p.detach().clone() for p in trainable(state.params)]
        state = model.place_state(state)
        ssg_cuda.launches = 0
        reset_k2_counts()
        state, first = model.train_step(state, batch)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                 for p in trainable(state.params)]
        state, second = model.train_step(state, batch)
        torch.cuda.synchronize()
        out[label] = {"logs": [{k: float(v) for k, v in x.items()} for x in (first, second)],
                      "grads": grads, "k1": ssg_cuda.launches, "k2": k2_counts(),
                      "update": [p.detach() - s for p, s in zip(trainable(state.params), start)],
                      "opt": type(state.opt).__name__, "mesh": model.distributed}
        del model, state, start
        torch.cuda.empty_cache()
    plain, mesh = out["plain"], out["mesh"]
    if not mesh["mesh"] or mesh["opt"] != "ZeroAdamW":
        fail(f"parallel: the diffusion model took no mesh ({mesh['mesh']}, {mesh['opt']})")
    log_err = max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-30)
                  for a, b in zip(plain["logs"], mesh["logs"]) for k in a)
    if not log_err <= TRAIN_LOG_RTOL:
        fail(f"parallel: diffusion losses {mesh['logs']} against {plain['logs']}")
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(mesh["grads"], plain["grads"]))
    den = sum(float((b ** 2).sum()) for b in plain["grads"])
    grad_err = (num / den) ** 0.5
    if not grad_err <= TRAIN_GRAD_REL_L2:
        fail(f"parallel: diffusion gradients {grad_err} from the plain mini-step's")
    lr = cfg["train"]["lr"]
    update_err = max(float((a - b).abs().max()) for a, b in zip(mesh["update"], plain["update"]))
    moved = max(float(a.abs().max()) for a in mesh["update"])
    if not (update_err <= 2.2 * lr and moved > 0):
        fail(f"parallel: diffusion update differs by {update_err} (moved {moved})")
    k2 = {k: v for k, v in mesh["k2"].items() if k not in ("k2_fwd", "k2_bwd")}
    if mesh["k1"] != 2 or not mesh["k2"]["k2_fwd"] or not mesh["k2"]["k2_bwd"] or \
            mesh["k2"] != plain["k2"]:
        fail(f"parallel: diffusion launches K1 {mesh['k1']}, K2 {mesh['k2']} against "
             f"{plain['k2']}")
    return {"size": PAR_DIFF_SIZE, "batch": TRAIN_B, "mini_steps": 2, "accumulate": 2,
            "num_res_blocks": 1, "max_log_rel_err": log_err, "grad_rel_l2": grad_err,
            "max_update_abs_err": update_err, "max_update": moved,
            "k1_launches": mesh["k1"], "k2_launches": {"fwd": mesh["k2"]["k2_fwd"],
                                                        "bwd": mesh["k2"]["k2_bwd"]},
            "k2_kernels": k2}


def k2_entries(k2, k2_bwd, k2_16, k2_bwd_16, paths) -> list:
    """The kernels line's K2 entries, float32 and bf16: the kernel phases'
    results by case (``phase_k2``, ``phase_k2_bwd`` and their bf16
    counterparts) and ``paths``, the launches by kernel name of each path
    that ran them ({"": {path: counts}, "_bf16": {path: counts}}; the
    backward's paths are those not serving)."""
    from torch_attention_cases import TRAIN_MIX_BWD

    both = f"{UPSTREAM_DKV}; {UPSTREAM_DQ}"
    bwd_kernels = {"dkv": UPSTREAM_DKV, "dq": UPSTREAM_DQ, "sum": both, "p_ds": both,
                   "dkv_mm": UPSTREAM_DKV, "dq_mm": UPSTREAM_DQ}
    bf16_note = " with bf16 q, k and v under compute_dtype (ssl_tpu/diffusion/unet.py:24-31)"

    def bwd_entry(f, replaces, sfx=""):
        """flash_attn_bwd_<f>[_bf16]: per-launch means over the launches one
        training mini-step's mix of shapes gives it (TRAIN_MIX_BWD calls per
        case)."""
        name, res = f"flash_attn_bwd_{f}{sfx}", (k2_bwd_16 if sfx else k2_bwd)
        runs = {c: w * res[c]["launches"][name] for c, w in TRAIN_MIX_BWD.items()
                if name in res[c]["launches"]}
        total = sum(runs.values())

        def per_launch(value):
            return sum(TRAIN_MIX_BWD[c] * value(res[c]) for c in runs) / total

        ops, nbytes, fp32 = (per_launch(lambda r, kind=kind: r["bounds"][f][kind])
                             for kind in ("ops_ms", "bytes_ms", "fp32_ops_ms"))

        def call_mean(key):
            return sum(TRAIN_MIX_BWD[c] * res[c][key] for c in runs) / sum(
                TRAIN_MIX_BWD[c] for c in runs)
        by_path = {path: counts.get(name, 0) for path, counts in paths[sfx].items()
                   if not path.startswith("serve")}
        entry = {"name": name, "route": "cuda",
                 "source": "ssl_tpu_torch/csrc/flash_attn_bwd.cu",
                 "replaces": replaces + (bf16_note if sfx else ""),
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": max(res[c]["max_abs_err"] for c in runs),
                 "ms": per_launch(lambda r: r["kernel_ms"][name]),
                 "bound_ms": max(ops, nbytes),
                 "fraction_of_bound": max(ops, nbytes) / per_launch(
                     lambda r: r["kernel_ms"][name]),
                 "bound_by": "operations" if ops >= nbytes else "bytes", "cases": sorted(runs)}
        if not sfx:
            entry["fp32_bound_ms"] = max(fp32, nbytes)
        what = ("the float32 reference's" if sfx else "the whole backward's")
        if f == "sum":
            entry.update(plain_ms=call_mean("sum_plain_ms"), library_ms=call_mean("sum_library_ms"),
                         times_are="mean per launch over one training mini-step's mix of shapes; "
                                   "plain_ms (an in-order loop) and library_ms (torch.sum) add "
                                   f"one output's split parts; max_abs_err is {what}")
        elif f.endswith("_mm"):
            entry.update(plain_ms=call_mean("mm_plain_ms"),
                         library_ms=per_launch(lambda r: r["mm_library_ms"][f]),
                         times_are="mean per launch over one training mini-step's mix of shapes; "
                                   "library_ms is cuBLAS's device time for this kernel's "
                                   "products (one torch.baddbmm each, TF32 and bf16 "
                                   "reduced-precision reduction off) on the P/dS scratch; "
                                   "plain_ms the plain dkv_mm and dq_mm together; max_abs_err is "
                                   f"{what}")
        else:
            entry.update(plain_ms=call_mean("plain_ms"), library_ms=call_mean("library_ms"),
                         times_are="mean per launch over one training mini-step's mix of shapes; "
                                   "plain_ms and library_ms (SDPA) time the whole backward "
                                   "(dq, dk, dv) per call at the shapes this kernel runs; "
                                   f"max_abs_err is {what}")
        if sfx:
            entry["rel_l2_vs_float32"] = max(max(res[c]["rel_l2"].values()) for c in runs)
        return entry

    def fwd_entry(f, sfx=""):
        """flash_attn_<f>[_bf16]: per-launch means over the launches one
        serving request's mix of shapes (SERVE_MIX) gives it; device times
        from the profiler.  The main kernels' plain and library times are the
        whole forward's; the combine's plain time is ``combine_parts``."""
        name, res = f"flash_attn_{f}{sfx}", (k2_16 if sfx else k2)
        mix = {c: w for c, w in SERVE_MIX.items() if name in res[c]["launches"]}
        total = sum(mix.values())

        def mean(value):
            return sum(w * value(res[c]) for c, w in mix.items()) / total

        if f == "fwd_combine":
            ops, nbytes = (mean(lambda r, kind=kind: r["combine_bounds"][kind])
                           for kind in ("ops_ms", "bytes_ms"))
            plain, library = mean(lambda r: r["combine_plain_ms"]), None
            if sfx:       # the kernel alone on seeded parts (hold_combine_bf16), by case
                alone = {c: res[c]["combine_alone"] for c in mix}
        else:
            ops, nbytes = mean(lambda r: r["ops_ms"]), mean(lambda r: r["bytes_ms"])
            plain, library = mean(lambda r: r["plain_ms"]), mean(lambda r: r["library_ms"])
        by_path = {path: counts.get(name, 0) for path, counts in paths[sfx].items()}
        extra = {"rel_l2_vs_float32": max(res[c]["rel_l2"] for c in mix),
                 "library_device_ms": None if library is None else
                 mean(lambda r: r["library_device_ms"])} if sfx else {}
        if sfx and f == "fwd_combine":
            extra.update(alone_by_case=alone,
                         floor_ms=max(a["floor_ms"] for a in alone.values()))
        return {"name": name, "route": "cuda", "source": "ssl_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": "ssl_tpu/ops/attention.py:28" + (bf16_note if sfx else ""),
                "launches": sum(by_path.values()), "launches_by_path": by_path, **extra,
                "max_abs_err": max(res[c]["max_abs_err"] for c in mix),
                "ms": mean(lambda r: r["device_ms"][name]),
                "wrapper_ms": mean(lambda r: r["ms"]), "plain_ms": plain, "library_ms": library,
                "bound_ms": max(ops, nbytes), "bound_by": "operations" if ops >= nbytes else "bytes",
                "cases": sorted(mix),
                "times_are": "mean per launch over one serving request's mix of shapes; ms is "
                             "the kernel's device time (profiler), wrapper_ms the call's (CUDA "
                             "events); library_ms is SDPA's by CUDA events and, in bf16, "
                             "library_device_ms its device time (profiler); max_abs_err is the "
                             "whole forward's"}

    return [*(fwd_entry(f, sfx) for sfx in ("", "_bf16")
              for f in ("fwd", "fwd_d512", "fwd_combine")),
            *(bwd_entry(f, replaces, sfx) for sfx in ("", "_bf16")
              for f, replaces in bwd_kernels.items())]


def kernels_line(k1, k2, k2_bwd, serve, train, launches, cli, realesrgan, dcli,
                 recipes, kair, bench, k2_16, k2_bwd_16, dbf16, prep, zoo, par, cfw) -> dict:
    """The {"kernels": [...]} line: one entry per kernel of the port, from the
    phases' results (K1's, K2's forward's and backward's by case, the serving
    K2 launches and forward kernel launches, the diffusion_train and
    diffusion_cli launch counts, the K1 launches of the ESRGAN train step
    and of the CLIs, the recipes phase's K1 launches and holds, and the kair
    phase's K1 launches by recipe and holds, the bench phase's K1
    launches by mode, and the prep_infer phase's train CLI's K1 launches; the
    zoo phase's CLI's K2 launches; the parallel phase's K1 launches (the DDP
    CLI runs and the StableSR-SSL mini-steps) and K2 launches; the cfw
    phase's K2 launches on the CFW CLI's steps and on its bf16 step; K2's
    bf16 kernels from the bf16 kernel phases and the diffusion_bf16 phase's
    launches).  K1's float32 mode and its bf16 stream
    + store mode (bench.py's step) each have an entry; ``modes`` under the
    first lists every mode held, the bf16 stream mode (the batched route)
    included.  Each K2 kernel has an entry, its bf16 counterpart
    (``_bf16``) another."""
    serve_calls, serve_fwd = serve
    paths = {"": {"serve": serve_fwd, "diffusion_train": train, "diffusion_cli": dcli,
                  "zoo_cli": zoo, "parallel": par["k2"], "cfw_cli": cfw["cfw_cli"]},
             "_bf16": {"serve_bf16": dbf16["serve"],
                       "diffusion_bf16_mini_steps": dbf16["mini_steps"],
                       "diffusion_bf16_cli": dbf16["cli"], "cfw_bf16_step": cfw["cfw_bf16_step"]}}
    realesrgan, realesrgan_host = realesrgan
    recipes, recipe_holds = recipes
    kair_launches, kair_holds = kair
    bench_launches = bench[0]
    shapes = {"b16_3x128^2": "main_path", "b2_3x512^2": "diffusion_smooth",
              "b24_3x128^2": "bench_f32",
              "b12_3x400^2": "realesrgan_edges", "b12_3x256^2": "realesrgan_host_edges",
              **{f"b{KAIR[r]['batch']}_3x{KAIR[r]['gt']}^2": f"kair_{r}" for r in KAIR}}
    k1_runs = {"main_path": launches + cli + recipes + prep,
               "diffusion_smooth": train["k1"] + dcli["k1"],
               "realesrgan_edges": realesrgan, "realesrgan_host_edges": realesrgan_host,
               "bench_f32": bench_launches["float32"],
               **{f"kair_{r}": n for r, n in kair_launches.items()}}

    def k1_mean(key):
        return sum(w * k1[c][key] for c, w in k1_runs.items()) / sum(k1_runs.values())

    def mode_entry(case, n):
        r = k1[case]
        return {"case": case, "route": "stored" if r["stored"] else "batched",
                "launches_on_paths": n, "ms": r["device_ms"], "wrapper_ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "max_abs_err": r["max_abs_err"]}
    bf16 = k1["bench_bf16"]
    bf16_launches = bench_launches["bf16_stream_store"]

    return {"kernels": [{
        "name": "ssg_loss_fwd", "route": "cuda", "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu",
        "replaces": "ssl_tpu/ops/ssg_pallas.py:41",
        "mode": "float32",
        "launches": launches + cli + train["k1"] + realesrgan + realesrgan_host + dcli["k1"]
        + recipes + sum(kair_launches.values()) + bench_launches["float32"] + prep + par["k1"],
        "launches_by_path": {"esrgan_train": launches, "esrgan_cli": cli,
                             "diffusion_train": train["k1"], "realesrgan_cli": realesrgan,
                             "realesrgan_host_cli": realesrgan_host, "diffusion_cli": dcli["k1"],
                             "recipes_cli": recipes, "kair_cli": sum(kair_launches.values()),
                             "bench_f32": bench_launches["float32"], "prep_infer_cli": prep,
                             "parallel": par["k1"]},
        "max_abs_err": max([k1[c]["max_abs_err"] for c in ("main_smooth", "diffusion_smooth",
                                                           "realesrgan_edges",
                                                           "realesrgan_host_edges",
                                                           "bench_f32")]
                           + [k1[f"kair_{r}"]["max_abs_err"] for r in KAIR]
                           + [max(h["max_abs_err"].values()) for h in recipe_holds.values()]
                           + [max(h["max_abs_err"].values()) for h in kair_holds]),
        "max_abs_err_on_recipe_sr": {**{r: max(h["max_abs_err"].values())
                                        for r, h in recipe_holds.items()},
                                     **{f"{h['recipe']}_seed{h['seed']}":
                                        max(h["max_abs_err"].values()) for h in kair_holds}},
        "ms": k1_mean("device_ms"), "wrapper_ms": k1_mean("ms"), "plain_ms": k1_mean("plain_ms"),
        "bound_ms": k1_mean("bound_ms"), "bound_by": k1["main_path"]["bound_by"],
        "library_ms": None,
        "ms_by_shape": {s: k1[c]["device_ms"] for s, c in shapes.items()},
        "bound_ms_by_shape": {s: k1[c]["bound_ms"] for s, c in shapes.items()},
        "plain_ms_by_shape": {s: k1[c]["plain_ms"] for s, c in shapes.items()},
        "times_are": "mean per launch over the run's launches (b16 3x128^2 in the ESRGAN "
                     "step and CLI, the six recipes' CLIs and the prep_infer train CLI, b2 3x512^2 in the diffusion "
                     "mini-step and its CLI, b12 3x400^2 in the RealESRGAN-SSL CLI, b12 "
                     "3x256^2 in its host mode, b48 3x256^2, b64 3x192^2 and b16 3x256^2 "
                     "in the KAIR family's CLIs); ms is the kernel's device time "
                     "(profiler), wrapper_ms the call's (CUDA events); max_abs_err on "
                     "smooth images, at b12 3x400^2 and 3x256^2 on pictures with real edge "
                     "masks, at the three KAIR shapes on such pictures with the stride-3 "
                     "mask, at b16 3x128^2 on SwinIR's and ELAN's SR of training pairs, and "
                     "at b16 3x256^2 on BSRGAN-SSL's SR of BSRGAN-degraded pairs with the "
                     "stride-3 mask (three seeds)",
        "modes": {"float32": mode_entry("bench_f32", bench_launches["float32"]),
                  "bf16_stream_store": mode_entry("bench_bf16", bf16_launches),
                  "bf16_stream": mode_entry("kair_BSRGANSSL_bf16", 0)}},
        {"name": "ssg_loss_fwd", "mode": "bf16_stream_store", "route": "cuda",
         "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu (template STREAM16, STORE16: the walk)",
         "replaces": "ssl_tpu/ops/ssg_pallas.py:41 (with ssl_tpu/ops/ssg.py:61,71's bf16 "
                     "knobs, ssl_tpu/ops/ssg.py:490-526)",
         "launches": bf16_launches, "launches_by_path": {"bench_bf16": bf16_launches},
         "max_abs_err": bf16["max_abs_err"], "ms": bf16["device_ms"], "wrapper_ms": bf16["ms"],
         "walk_ms": bf16["kernels_device_ms"]["ssg_loss_fwd_kernel"],
         "stream_ms": bf16["kernels_device_ms"]["ssg_loss_fwd_stream_kernel"],
         "call_peak_gb": bf16["call_peak_gb"],
         "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
         "bound_by": bf16["bound_by"], "library_ms": None,
         "stack_hold": bf16["stack_hold"],
         "times_are": "b24 3x128^2, bench.py's step on the stored route; ms is the device time "
                      "(profiler) of K1's two kernels together, the walk (walk_ms) and the "
                      "stream (stream_ms), against the function's bound; wrapper_ms the "
                      "call's (CUDA events); call_peak_gb the call's peak device memory above "
                      "its inputs (the q stack); plain_ms the plain version in the same mode"},
        {"name": "ssg_loss_fwd_stream", "mode": "bf16_stream_store", "route": "cuda",
         "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu (ssg_loss_fwd_stream_kernel)",
         "replaces": "ssl_tpu/ops/ssg_pallas.py:41's second sweep, as the stored route takes it "
                     "from its q stack (ssl_tpu/ops/ssg.py:600 _ssl_loss_dense_core_stored, "
                     "_q_decode :520)",
         "launches": bench_launches["stream_kernel"],
         "launches_by_path": {"bench_bf16": bench_launches["stream_kernel"]},
         "max_abs_err": max(v for k, v in bf16["stack_hold"]["max_abs_err"].items()
                            if k.startswith("stream")),
         "ms": bf16["kernels_device_ms"]["ssg_loss_fwd_stream_kernel"],
         "plain_ms": bf16["stream"]["plain_ms"], "bound_ms": bf16["stream"]["bound_ms"],
         "bound_by": bf16["stream"]["bound_by"], "library_ms": None,
         "times_are": "b24 3x128^2 on the walk's stack; ms the kernel's device time (profiler); "
                      "plain_ms q_stream_reference on the same stack; bound_ms the stream's own "
                      "inputs and outputs (the stack read once is this design's traffic, not "
                      "the function's: K1's bound is the entry above's); max_abs_err against "
                      "the plain stream on the same stack"},
        *k2_entries(k2, k2_bwd, k2_16, k2_bwd_16, paths)]}


# The recipes phase runs in a process of its own (``start_phase_child``)
# beside the diffusion_cli phase: both spend most of their time on the host
# (building, saving and reloading nets, loader processes, the host degrader)
# and neither times a kernel.  It has CHILD_TIMEOUT seconds.
CHILD_TIMEOUT = 900


def start_phase_child(name: str) -> dict:
    """Start ``python3 chip_smoke.py --phase <name> --result <file>``: the
    phase alone in a process of its own, its JSON lines and errors written
    to files and its result to a JSON file, which ``join_phase_child``
    prints and reads.  Returns its handle."""
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_")
    files = {k: open(os.path.join(tmp.name, k), "w") for k in ("out", "err")}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase", name,
                             "--result", os.path.join(tmp.name, "result.json")],
                            cwd=ROOT, stdout=files["out"], stderr=files["err"])

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files.values():
            f.close()
        tmp.cleanup()
    STOP.append(stop)
    return {"name": name, "proc": proc, "root": tmp.name, "stop": stop}


def join_phase_child(child: dict):
    """Wait for a ``start_phase_child`` process, print its JSON lines and
    errors, and fail if it failed.  Returns its phase's result and the
    seconds the phase took there."""
    proc, name = child["proc"], child["name"]
    try:
        proc.wait(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    for k, stream in (("out", sys.stdout), ("err", sys.stderr)):
        with open(os.path.join(child["root"], k)) as f:
            stream.write(f.read())
        stream.flush()
    if proc.returncode != 0:
        fail(f"{name}: its process exited {proc.returncode}")
    with open(os.path.join(child["root"], "result.json")) as f:
        done = json.load(f)
    child["stop"]()
    STOP.remove(child["stop"])
    return done["result"], done["seconds"]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ssl_tpu_torch")):
        print("chip_smoke: ssl_tpu_torch/ is not beside this script; run it from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.join(ROOT, "tests"))      # torch_*_cases (JAX-free)
    if sys.argv[1:2] == ["--phase"]:                     # start_phase_child's process
        name, result = sys.argv[2], sys.argv[4]
        t0 = time.perf_counter()
        out = {"recipes": phase_recipes}[name]()
        with open(result, "w") as f:
            json.dump({"result": out, "seconds": time.perf_counter() - t0}, f)
        return 0
    try:
        return phases()
    finally:
        for stop in STOP:
            stop()


def phases() -> int:
    """The phases in their order, the wall line, the kernels line, the card
    and the last line."""
    import tempfile

    import torch
    wall, start = {}, time.perf_counter()

    def run(name, phase, *args):
        """``phase(*args)``, its wall seconds kept for the ``wall`` line."""
        t0 = time.perf_counter()
        out = phase(*args)
        wall[name] = time.perf_counter() - t0
        return out

    from concurrent.futures import ThreadPoolExecutor

    zoo_refs = zoo_start_refs()
    # seeded metric checkpoints for the metrics phase and every later test CLI
    # run; the metrics phase needs none of the port's kernels, so it runs on
    # the card while nvcc builds them
    metric_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_metrics_")
    metric_weights(metric_dir.name)
    with ThreadPoolExecutor(1) as builder:
        built = builder.submit(run, "build", phase_build)
        run("metrics", phase_metrics)
        built.result()
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # K2 first: after K1's holds at the KAIR shapes the profiler's traces of
    # K2's forward missed one to five of ten launches (PERF.md)
    k2 = run("k2", phase_k2)
    k2_bwd = run("k2_bwd", phase_k2_bwd)
    k2_16 = run("k2_bf16", phase_k2_bf16)
    k2_bwd_16 = run("k2_bwd_bf16", phase_k2_bwd_bf16)
    run("k2_d512_bf16", phase_k2_d512_bf16)
    k1 = run("kernel", phase_kernel)
    model, state = run("diffusion", phase_diffusion)
    run("e2e", phase_e2e, model, state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    serve = run("serve", phase_serve, model, state)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run("train_e2e", phase_train_e2e, model, state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dbf16 = run("diffusion_bf16", phase_diffusion_bf16, model, state)
    train = run("diffusion_train", phase_diffusion_train, model, state)
    cfw = run("cfw", phase_cfw, model, state)
    del model, state
    torch.cuda.empty_cache()
    recipes_child = start_phase_child("recipes")
    dcli = run("diffusion_cli", phase_diffusion_cli)
    t0 = time.perf_counter()
    recipes, wall["recipes"] = join_phase_child(recipes_child)
    wall["recipes_wait"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    zoo = run("zoo", phase_zoo, zoo_refs)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    launches = run("train", phase_train)
    torch.cuda.empty_cache()
    bench = run("bench", phase_bench)
    torch.cuda.empty_cache()
    cli = run("cli", phase_cli)
    torch.cuda.empty_cache()
    realesrgan = run("realesrgan", phase_realesrgan)
    torch.cuda.empty_cache()
    kair = run("kair", phase_kair)
    torch.cuda.empty_cache()
    dist_train = run("parallel_torchrun_start", start_dist_train)
    prep = run("prep_infer", phase_prep_infer)
    torch.cuda.empty_cache()
    par = run("parallel", phase_parallel, dist_train)

    metric_dir.cleanup()
    emit({"phase": "wall", "seconds": wall, "total_s": time.perf_counter() - start})
    emit(kernels_line(k1, k2, k2_bwd, serve, train, launches, cli, realesrgan, dcli, recipes,
                      kair, bench, k2_16, k2_bwd_16, dbf16, prep, zoo, par, cfw))
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
