#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and serving paths on one GPU and
check them.

    python3 chip_smoke.py            # all phases, one card

Paths: unet_small (bf16, 32 px) trained at batch 128 and served, on kernels
#1-#4 (also as ImprovedDDPM, as the class-conditional, guided
ConditionalDDPM, as ScoreSDE, as WaveGrad's FiLM U-Net, as EDM and
ConditionalEDM, with ConvNeXt blocks, and as SR3 with a 6-channel stem at
32 and 64 px, served on /super_resolve and cascaded), and under the JAX package's two
opt-in switches on #6
(``DMN_TPU_PALLAS_NORM_BM=1``) and #9 (``DMN_TPU_PALLAS_LINATTN_BLOCK=1``);
``Block(x, scale_shift)`` at unet_small's GroupNorm sites on #5 (and #6
under its switch); DiT-S/2 (bf16, 64 px) on kernel #7; the float32
unet_small on kernels #1 and #8; the kernel microbenchmarks
(``diffusion_model_nemo_tpu_torch/tools/``) on #10-#13; the WaveGrad
vocoder, whose 1-D convolutions are cuDNN's (no TPU kernel stands behind
them in the JAX package either).

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and build the
     hand-written Hopper kernels from ``diffusion_model_nemo_tpu_torch/csrc``
     (one nvcc per source, all in parallel).
  2. Hold every kernel against its plain PyTorch version on the card, at
     every shape the unet_small, flagship, float32 unet_small and DiT-S/2
     forwards send it at B=64 (inputs recorded from a real forward; #7 also in float32 and #8
     also in bf16 at one shape), at rtol = atol = 2e-2 in
     bf16 (the JAX package's kernel-test tolerance) and 1e-4 in float32
     (the same math with f32 sums in another order); time kernel, plain
     version, a one-call PyTorch yardstick where one exists (CUDA events
     around 20 back-to-back calls, so host launch gaps count where the host
     is the limit; the logs add the device time per call from
     torch.profiler), and the least time the card could take (bytes at
     3.35 TB/s or operations at the peak rate of their type, whichever is
     larger). #11 and #6 also log their device time by kernel name at every
     shape. #7 is also held in bf16 at shapes the DiT does not send (a
     ragged N at d = 32 and 64, d = 128, N = 4096, k and v cut from one qkv
     tensor as the DiT cuts them) and #4 at N = 8, 64 and 32 and at C = 48.
     #9 computes #10's function in bf16 and is held against #10's plain
     version (``linear_attention_block_v2_reference``); #2 against its own
     (``linear_attention_block_packed_reference``, the TPU kernel's seams);
     #3 and #12 (the whole-block kernel's core mode) against theirs
     (``linear_attention_tokens_fused_reference``, through the packed view
     for #12), and #8 (the whole-block kernel's raw mode) against its
     own (``linear_attention_qkv_fused_reference``: f32 throughout, one
     cast), with a seam check in bf16 besides the tolerance: against the
     same plain version with its sums in float64 (the same bf16 roundings),
     max |diff| at most one bf16 step at the output's scale (2^-7 max |ref|)
     and at most 2% of the elements differing. #2, #9 and #10 are also held at the
     corners of their gates ([2,4096,32], [2,4096,128] in the recompute
     form, [3,100,128] ragged, [2,64,128]; #10 also in float32 at
     [2,4096,32]), #3 at [2,4096,32], [2,4096,128], [2,4096,256] (the
     core's recompute form), [3,104,128] ragged and [2,64,128], #8 in both
     dtypes at [2,4096,384] (a cluster of 16, reloading its tiles),
     [3,104,384] ragged and [2,64,384], #1 and #5 in float32 at [64,32,32,32], at
     B = 1, at bf16 [1,64,64,128] (a cluster's shares in shared memory), at
     bf16 [1,128,128,128] (a slab beyond a cluster's shared memory: read
     twice) and at C = 48. These log their device time by
     kernel name. A #1, #2, #3, #5, #6, #8, #9, #10 or #12 call must run
     exactly one kernel (no copy or memset) and repeat bit for bit.
  3. One U-Net forward at B=64 per bf16 configuration and one DiT-S/2
     forward with the kernels, against the same forward with every kernel
     swapped for its plain version (TF32 off for both), with device-time
     breakdowns of the unet_small and DiT forwards; the float32 route: the
     GroupNorm kernel in float32, a float32 unet_small forward against its
     plain path, and a 10-step DDIM chain with #8's launches counted.
  Every loop below runs as CUDA graph replays (``ops/graphs.py``; a
  replay adds its capture's launch counts, so launches stay calls made).
  4. The main path: ``SamplingServer`` on unet_small (full width, random
     weights from a seed) with DDIM-50 and max_batch=64 answers /healthz,
     /stats and /sample requests (concurrent png + npy, one seed twice); the
     images decode, the seeded one repeats bit for bit and equals the eager
     chain's, and every kernel's launch count equals its per-forward count
     x 50 steps x batches.
     4b. The same on DiT-S/2 at 64 px (full width and depth, seeded random
     weights with the adaLN-Zero leaves redrawn) with max_batch=32.
  5. A short ancestral chain (p_sample_loop, 10 steps).
  6. The training slice at B=128:
     6a. unet_small and flagship forwards under each switch against the
         plain path, with the launches per forward equal to those the gates
         derive (a shapes-only forward on meta tensors);
     6b. the FiLM path: ``Block(x, scale_shift)`` with per-sample FiLM from a
         time MLP at each of unet_small's 35 GroupNorm sites, forward and
         backward, against the plain path; #5 launches 35 times, 0 in the
         backward (and #6 27 times under its switch);
     6c. one unet_small training step with kernels against the plain path
         from the same weights and draws (loss, whole gradient), 0 kernel
         launches in the backward; per kernel call of the step, the kernel's
         time against its backward's plain recompute;
     6d. ``Trainer.fit`` of unet_small for 20 steps on the synthetic set
         (finite losses, the EMA moved, launches = 20 x per forward), step
         time, samples/s and the device-busy share of a step; after the
         20 steps the weights each attention layer's kernel derives from
         its parameters (prenorm fold, casts, re-layouts), kept per
         parameter version, equal a fresh derivation bit for bit; then 5
         steps under both switches (#6 = 27, #9 = 1, #3 = 0 per step).
  Every new kernel (#5, #6 plain and FiLM, #9) is held against its plain
  version at every shape these paths give it, as in phase 2, and so are
  #1-#4 at the training step's B=128 shapes.
  7. The tools path: the three microbenchmarks' ``run()`` at their full
     shapes (``microbench_attn``: composed, #9, #10 at [128,1024,32] and
     [128,256,64]; ``microbench_conv``: cuDNN and #11 at six shapes;
     ``microbench_attn_lanes``: #3 and #12 at the attention shapes, #13 at
     [4096|8192|32768, 128]), their lines logged as ``[tool]``; every
     kernel's launches equal the calls the tools made; #10-#13 held against
     their plain versions at every shape the tools give them (bf16 2e-2),
     #10-#12 also in float32 at one shape (1e-4), #13 bit for bit (also in
     float32 at [4096,128] and at a ragged [1000,96] in bf16), and timed
     as in phase 2, and #9 at the two shapes microbench_attn gives it; #11's
     sum over the six conv shapes against cuDNN's; ``conv3x3_tap_split`` under ``DMN_TPU_TAP_SPLIT_CONV=1``
     launches #11 once forward and nothing backward, its gradients against
     autograd through the plain conv.

  8. The README's usage path through the port's CLIs, in a temporary
     directory, at ``examples/configs/ddpm/unet_small.yaml``'s full width
     (32 px, bf16, batch 128): ``train_ddpm`` for 20 steps (a sample grid
     from the 1000-step ancestral chain and a checkpoint every 10, the
     final ``.dmn``), a second ``train_ddpm`` resuming from step 20 to 30,
     the archive's forward against the trained model's bit for bit,
     ``eval_ddpm`` (DDIM-50, batch 64: its PNGs equal ``DDPM.sample`` on the
     same seed), ``test_ddpm`` (bits/dim of a batch of 32 at T = 1000),
     bits/dim at T = 50 with the same noise on the kernel path and the plain
     path (bf16 2e-2, the float32 U-Net on #8 1e-3 relative; the replayed
     loop equals the eager one bit for bit, in float32 under
     ``cudnn.deterministic``: its convolutions differ from run to run
     otherwise), and ``serve``
     from the archive path (one /sample of 4 PNGs). Each step's launches are
     counted from 0 and each kernel of its path must have run; none of
     PyYAML, msgpack, flax, orbax or Pillow may be imported. ``[cli]`` lines
     give each step's seconds.
  9. CUDA graphs against the eager loops, a ``[graph]`` line each (captured
     wall, device busy, eager wall, capture seconds, nodes, pool MiB,
     launches = captured counts x replays): the optimizer's and the EMA's
     tabled scalars against Python floats (bit for bit); DDIM-50 on
     unet_small (B=64) and DiT-S/2 (B=32), == eager bit for bit, and the
     captured step's device split;
     the 1000-step ancestral dump chain at batch 4 (== eager, generator
     state equal); bits/dim at T = 1000, B = 32 (total_bpd == eager);
     ``Trainer.fit`` at B=128, 20 steps, eager twice, captured at
     ``steps_per_execution`` 1 and 4 (bit-equal to eager where eager
     repeats itself, else within its difference; K = 4 == K = 1; logged
     steps by the JAX trainer's rule); a replay after an in-place AdamW
     step and after an EMA swap == eager, while the graph captured before
     the step, replayed by hand, differs (stale derived weights).
  10. The two families at their shipped configs' full width (32 px, bf16,
     T = 1000, cosine), a ``[family]`` line each check:
     10a. ImprovedDDPM (``examples/configs/improved_ddpm/unet_small.yaml``,
          learned variance): one B=128 training step with the kernels against
          the plain path from the same weights and draws (the four metrics
          2e-2 relative, the whole gradient 2e-2 relative L2, no launch in
          the backward); the captured step's wall, busy and pool;
          ``Trainer.fit`` for 20 captured steps (finite losses, launches = 20
          x one forward's); the 1000-step ancestral chain at B=16 as graph
          replays == eager bit for bit under ``cudnn.deterministic``;
          bits/dim at T = 1000 (B=32, captured) and at T = 50 on the kernel
          path against the plain path with the same noise (2e-2).
     10b. ConditionalDDPM (K = 10): one training step against the plain
          path with the label mask injected; ``SamplingServer`` DDIM-50,
          max_batch 64: /sample with label 3, without a label, guided (label
          3, w = 3.0, seeded: == the eager guided chain bit for bit) and with
          a bad label (400); launches = one forward's x 50 x batches (a
          guided step is one 2B forward); DDIM-50 images/s with and without
          guidance.
     10c. DiT-S/2 at 64 px with ``num_classes=10``: one forward with #7
          against the plain path, labels and null rows mixed.
     10d. The CLIs: ``train_improved_ddpm`` (10 steps, a .dmn) then
          ``test_improved_ddpm`` (bits/dim of 32 images at T = 1000);
          ``train_conditional_ddpm`` (10 steps), ``eval_conditional_ddpm``
          (label 3, w = 3.0, DDIM-50) and ``serve`` from its archive; none of
          PyYAML, msgpack, flax, orbax or Pillow imported.

  11. ScoreSDE at ``examples/configs/score_sde/vp/unet_small.yaml``'s full
     width (32 px, dim 32, dim_mults [1,2,4,8], 4 GroupNorm groups, bf16,
     N = 1000; random weights from seed 0), ``[sde]`` lines:
     11.1 its U-Net's launches per forward and GroupNorm groups (4 at every
          site), #1-#4 held against their plain versions at each of its
          sites (bf16 2e-2, one launch a call, timed as in phase 2);
     11.2 one bf16 forward at float labels t*999 against the plain path
          (relative L2 3e-2);
     11.3 the config's PC sampler (Euler-Maruyama, no corrector), B=64: a
          20-step captured prefix == eager bit for bit (cudnn.deterministic),
          then the 1000-step chain captured: wall, device busy per step,
          images/s, pool, launches = per forward x 1000;
     11.4 reverse_diffusion and ancestral_sampling x langevin and ald
          (n_steps 1): each a 20-step captured prefix == eager;
     11.5 a .dmn archive restored by ``restore_model_from_archive`` and
          served with its own PC sampler (max_batch 64): /sample png and a
          seeded npy, latency, images/s, launches = per forward x 1000 x
          batches; ``use_ddim_sampler=True`` refused;
     11.6 one B=128 training step with the kernels against the plain path
          (loss 1e-2, whole gradient 2e-2 relative L2, nothing launched in
          the backward) and the captured step's ms, samples/s, busy, pool;
     11.7 ODE bits/dim at B=32 (rtol = atol = 1e-5), captured: success and
          finite bpd, NFE, s a batch (one solve on the host clock), the
          replays after ``done``, busy share, pool; one evaluation's vjp
          launches nothing; the plain path's solve (captured, the same
          tolerances, batch and probe) against the kernel path's within
          2e-2 relative, both NFEs printed;
     11.8 probability-flow sampling at B=64 with the denoising step: NFE,
          s, the replays after ``done``;
     11.9 sub-VP and VE: one forward against the plain path and a 50-step
          captured PC prefix == eager;
     11.10 the CLIs: ``train_score_sde`` (3 steps at B=128,
          ``compute_bpd=false``), ``eval_score_sde`` on its archive (B=64:
          PC, then probability flow), ``test_score_sde`` (one batch of 8);
          none of PyYAML, msgpack, flax, orbax or Pillow imported.

  12. The WaveGrad family, ``[wavegrad]`` and ``[vocoder]`` lines:
     12.1 WavegradDDPM at ``examples/configs/wavegrad_ddpm/unet_small.yaml``
          (32 px, dim 32, [1,2,4,8], 8 groups, bf16, linear beta 1e-6 ->
          0.01, T = 1000; random weights from seed 0): #1-#4 at its sites
          (continuous levels, B=64) against their plain versions; the
          forward against the plain path (3e-2);
     12.2 the B=128 step, kernels against plain (loss 1e-2, gradient 2e-2,
          no backward launch), the captured step's ms, busy and pool;
     12.3 the ancestral chain at B=64: a 100-step captured prefix == eager
          bit for bit (cudnn.deterministic) in bf16, the config's dtype,
          which routes #2-#4 (float32 would route #8 instead, as in 10a),
          the 1000-step chain captured (s, busy and device split a step,
          launches = per forward x 1000);
     12.4 the searched 50-step schedule (100 candidates, seed 0): beta_end
          == the numpy search's; its chain on the same sampler, captured
          == eager bit for bit, on a graph that holds the new table; the
          restore (the original table tensors, the 1000-step graph kept);
     12.5 bits/dim at T = 1000, B = 32, captured, against the plain path
          (captured, the same noise) within 2e-2;
     12.6 the archive restored by ``restore_model_from_archive`` and served
          on its own ancestral chain: one /sample, launches = per forward x
          1000 x batches;
     12.7 ``train_wavegrad_ddpm`` (B=128, a dump: search, 50-step chains,
          restore, bits/dim), ``eval_wavegrad_ddpm``, ``test_wavegrad_ddpm``;
     12.8 the vocoder at ``vocoder.yaml`` (24 kHz, hop 300, 80 mels,
          7200-sample segments, B=32, bf16): the step's loss against the
          float32 run of the same weights and draws (2e-2), 3 captured
          steps == eager (cudnn.deterministic), the captured step's ms,
          busy, split and pool;
     12.9 ``vocode`` at the searched 50-step schedule (500 candidates):
          captured == eager, s a batch, busy and split a step;
     12.10-12.12 the archive round trip bit for bit; /vocode served (a
          seeded request repeats, /sample answers 400); ``train_vocoder``
          and the ``vocode`` CLI; none of PyYAML, msgpack, flax, orbax or
          Pillow imported.

  13. The DDPM family's sampling services on unet_small (bf16, full width,
      random weights from seed 0), ``[svc]`` and ``[graph] svc`` lines:
     13a DDIM-50, DPM-Solver++(2M)-20, UniPC-20 (order 2, corrector) and
          Karras-18 (Heun, NFE 35) at B=64: captured == eager bit for bit
          twice (cudnn.deterministic), captured and eager wall, device busy,
          NFE, launches = one forward's (two for Heun) x replays;
     13b ``serve`` with each flag: images/s over a 3 s window of four
          concurrent clients (requests of 16, 48, 32 and 32 images,
          coalesced into batches of 64), launches = one forward's x NFE x
          batches;
     13c the guided ConditionalDDPM under DPM (one 2B forward a step),
          captured == eager; 13d ImprovedDDPM refused by the three;
     13e ``return_frames``: the ancestral chain's last 50 steps and DPM's
          chain captured == eager, frames included; the T = 1000 chain's
          frames (MiB, peak memory);
     13f interpolation: ancestral (t = 50 captured == eager, t = 999
          timed) and DDIM-50 from 8 slerped latents;
     13g SDEdit: strength 0.05 captured == eager; POST /edit at 0.25 and
          0.75 on a DDIM-configured server (a seeded request twice, two
          unseeded ones coalesced; launches = one forward's x t0 x
          batches; both strengths replay one ancestral graph), the
          400s (/super_resolve on this DDPM archive among them);
     13h RePaint at B=8, jumps 10 x 10 (9910 reverse entries): the first
          200 entries captured == eager, the whole schedule captured, the
          known region exact, launches = one forward's x 9910;
     13i ``eval_ddpm`` with each sampler flag and ``show_diffusion``,
          ``interpolate_ddpm``, ``interpolate_improved_ddpm``,
          ``interpolate_ddim``, ``edit_ddpm``, ``inpaint_ddpm`` from
          archives of these models, each writing its files; none of
          PyYAML, msgpack, flax, orbax or Pillow imported.

  14. The training options and the Trainer's services on unet_small at
      B=128 (bf16, full width, random weights from seed 0), ``[opts]``
      lines:
     14a Min-SNR-γ 5 + offset noise 0.1 + dropout 0.1 (17 keep masks among
          the draws), and pred_v + zero terminal SNR: each step against the
          plain path (loss 1e-2, gradient 5e-2, no launch in the
          backward), 3 captured steps within eager's spread, the captured
          step's wall and busy;
     14b the pred_v + zero-terminal-SNR DDIM-50 chain at B=64 captured ==
          eager bit for bit (cudnn.deterministic), finite;
     14c accumulation, 2 micro-batches of 64 as one captured step: loss and
          gradient against one step of 128 on the same samples and draws,
          3 captured steps within eager's spread, ms and samples/s;
     14d post-hoc EMA at two σ_rel over a 6-step fit: snapshots,
          ``reconstruct_ema`` to an archive that serves a DDIM-50 batch, the
          update's cost in the captured step;
     14e/f a 16-step fit through the prefetcher with ``profile_dir`` over
          steps 4-8: the trace written with its device events, samples/s,
          the window's idle share;
     14g a conditional server at two guidance scales: the second replays
          the guided graph the first captured.

  15. The ConvNeXt U-Net and the EDM family (bf16, full width, random
      weights from seed 0, 32 px), ``[edm]`` lines, each time beside the
      card's name and power limit:
     15a unet_small with ConvNeXt blocks (use_convnext, convnext_mult 2):
          launches a forward at B=64 and 128 (#1 once, at final_norm; #2
          four times; #3, #4 once) equal to the gates', #1-#4 held at every
          shape, the B=64 forward against the plain path, the captured
          DDIM-50 chain == eager, the B=128 step against the plain path
          (nothing launched in the backward) and captured;
     15b EDM at examples/configs/edm/unet_small.yaml: #1-#4 held at its
          forward's shapes (float times); the Heun-18 chain at B=64 (NFE
          35), with churn 40 (injected noise) and as Euler-18, captured ==
          eager bit for bit (cudnn.deterministic), launches = the graphs'
          counts x replays, wall, busy; the augmented B=128 step
          (augment_prob 0.12, aug_dim 9) against the plain path, captured;
     15c the likelihood at B=32 (NFE 34, the vjp's backward in the
          captured step, launching nothing): bits/dim against the plain
          path (2e-2), captured == eager;
     15d encode at B=64 and the chain back, interpolate 16 pairs,
          captured == eager;
     15e the .dmn round trip (the same chain), the sampler swaps refused,
          /sample served with the archive's Heun-18 (seeded: EDM.sample's
          images), launches = one forward's x 35 x batches;
     15f train_edm (augmented, 3 steps at batch 8, a dump and bits/dim),
          eval_edm (churn, the GIF), test_edm (loss, ODE bits/dim, NFE 34);
     15g ConditionalEDM (K = 10): #1-#4 held at the guided 2B forward's
          shapes, /sample guided at two scales: the second replays the two
          guided graphs (the Heun steps', the last Euler step's) the first
          captured, and captures nothing.

  16. SR3 super-resolution, the cascade and the file datasets (bf16, full
      width, random weights from seed 0), ``[sr3]`` lines, each time beside
      the card's name and power limit:
     16a SR3 at examples/configs/sr3/unet_small.yaml, 32 px x4 and 64 px x2:
          launches a forward equal to the gates' (#1-#4 35/4/1/1 at 32 px,
          as unet_small's), every #1-#4 call of the 32-px forward at B=64
          and 128 and of the 64-px forward at B=16 held against its plain
          version with its device ms (CUDA events behind a spin) and bound,
          both forwards against the plain path, busy ms beside unet_small's;
     16b the B=128 step, plain and with cond_aug_std 0.1 (its draw
          injected): loss and gradient against the plain path, no launch in
          the backward, the captured step == eager (cudnn.deterministic),
          wall and busy;
     16c super_resolve at B=64: the ancestral chain's last 50 steps, then
          DDIM-50 and DPM-20 after swaps, each for two LR batches back to
          back through one graph, each == its eager chain bit for bit
          (cudnn.deterministic); the ancestral T = 1000, DDIM and DPM chains
          timed, launches = the graphs' counts x replays;
     16d conditional bits/dim at T = 1000, B = 32 against the plain path
          (2e-2), at T = 50 captured == eager;
     16e a SamplingServer on a restored SR3 archive (DDIM-50): uint8 and
          float /super_resolve inputs, seeded requests repeat, two unseeded
          ones under hold() run as one batch, /sample 400, a DDPM archive's
          /super_resolve 400, images/s over a window of four clients;
     16f the cascade unet_small@32 (DDIM-50) -> SR3@64 at B=16 == its stages
          by hand and == ``from_archives``, each stage's ms;
     16g train_sr3 (3 steps at batch 8 on an npz written here, a dump and
          bits/dim), eval_sr3 and cascade_sr3 at batch 8, a PNG folder with
          labels.npy through build_dataloader with resize_to; no Pillow,
          PyYAML, msgpack, flax or orbax imported.

  17. Rectified flow and reflow (bf16, full width, random weights from
      seed 0), ``[rf]`` lines, each time beside the card's name and power
      limit:
     17a RectifiedFlow at examples/configs/rectified_flow/unet_small.yaml,
          32 px: launches a forward (float times t·1000) equal to the gates'
          and to 35/4/1/1, #1-#4 held at its shapes;
     17b the B=128 step: loss and gradient against the plain path, no
          launch in the backward, the captured step == eager
          (cudnn.deterministic), wall and busy;
     17c Euler-50 and Heun-50 (NFE 99: 49 corrected steps, then one Euler
          step, a graph of its own) at B=64, captured == eager bit for bit,
          launches = the graphs' counts x replays, wall, busy (cudnn.
          deterministic);
     17d encode at B=64 and interpolate 16 pairs (grid 10), captured ==
          eager;
     17e the exact likelihood at B=32 (Euler, M = 50, one vjp a step in
          the captured step, launching nothing): captured == eager, wall
          and busy (cudnn.deterministic), bits/dim against the plain path
          (2e-2);
     17f the fused reflow step at B=64, pair_steps 50 (the teacher's chain,
          the student's forward and backward, clip and AdamW in one graph):
          captured == eager over two steps, launches = one forward's x 51,
          wall, busy (cudnn.deterministic), the graph's pool in MiB;
     17g two reflow rounds of two steps, pair steps 10 (round 2 captures
          anew on round 1's student as its teacher), student_model(sample_steps=1), its
          .dmn restored, the sampler swaps refused, /edit 400, /sample
          served over a window of four clients (images/s, fill), launches =
          one forward's x batches;
     17h train_rectified_flow (2 steps at batch 8, a dump), eval_
          rectified_flow (Heun-10, the GIF), test_rectified_flow (loss,
          exact bits/dim, NFE 50), reflow_rectified_flow (2 steps, pair
          steps 10, a one-step archive; devices=2 refused).

The last two lines are a JSON object with one entry per kernel and the
result line {"ok": true, "device": {...}}. Any failure exits non-zero and
prints no result. Without a CUDA device, or outside the repository, it fails.
"""

from __future__ import annotations

import base64
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

# The measurement every card check of the port shares (CUDA events, profiler
# device time by kernel name, the work a kernel's function must do); outside
# the repository this import fails, and so does the script.
from diffusion_model_nemo_tpu_torch.tools.profiling import (
    PEAK_BYTES_PER_S, PEAK_OPS, device_ms, device_profile, kernel_launches, queued_us, time_ms, work,
)

# Softmax attention's second limit: one exp2 per score, 16 a clock on each of
# the 132 SMs' special-function units, at the 1.98 GHz boost clock.
PEAK_EXP2_PER_S = 16 * 132 * 1.98e9
B = 64
TOL = 2e-2  # kernel vs plain, bf16: tests/test_ops_kernels.py
F32_TOL = 1e-4  # kernel vs plain, float32: f32 sums in another order
UNET_REL_TOL = 3e-2  # whole network, kernels vs plain path, relative L2 in bf16
F32_REL_TOL = 1e-4  # whole float32 U-Net, kernels vs plain path, relative L2
DDIM_STEPS = 50
DIT_MAX_BATCH = 32
DIT_IMG = 64
SEED = 0
TRAIN_B = 128  # unet_small's own training batch (examples/configs/ddpm/unet_small.yaml)
TRAIN_STEPS = 20
SWITCHED_STEPS = 5
LOSS_REL_TOL = 1e-2  # training step, kernels vs plain path: loss
GRAD_REL_TOL = 5e-2  # and the whole gradient, relative L2
# Phase 8, the README's usage path (examples/configs/ddpm/unet_small.yaml at
# 32 px, its own batch 128): train 20 steps (a sample dump and a checkpoint
# every 10), resume to 30, DDIM-50 eval at batch 64, bits/dim at T = 1000 on
# one batch of 32; bits/dim kernels vs plain at T = 50 (bf16 2e-2 and the
# float32 U-Net 1e-3 relative, total_bpd); serving from the archive.
CLI_CONFIG = ["--config-path=examples/configs/ddpm", "--config-name=unet_small.yaml"]
CLI_IMG = 32
CLI_MODEL = [f"model.image_size={CLI_IMG}"]
CLI_STEPS, CLI_RESUME_STEPS, CLI_EVERY = 20, 30, 10
CLI_EVAL_B, CLI_TEST_B, CLI_BPD_T, CLI_DDIM = 64, 32, 50, 50
BPD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
# Packages the card's machine lacks: phase 8 must run without any of them.
NOT_ON_THE_CARD = ("yaml", "msgpack", "flax", "orbax", "PIL", "jax", "diffusion_model_nemo_tpu")
NORM_BM = {"DMN_TPU_PALLAS_NORM_BM": "1"}
LINATTN_BLOCK = {"DMN_TPU_PALLAS_LINATTN_BLOCK": "1"}
BOTH = {**NORM_BM, **LINATTN_BLOCK}
# The configuration whose forward is each kernel's main path (per-forward sums).
MAIN_CFG = {
    "group_norm_silu": "unet_small",
    "linear_attention_block": "unet_small",
    "linear_attention_tokens": "unet_small",
    "attention_block_small": "unet_small",
    "linear_attention_qkv": "unet_small_f32",
    "attention": "dit_s2",
    "group_norm_silu_film": "film_block",
    "group_norm_silu_bm": "unet_small_128_switched",
    "linear_attention_block_v1": "unet_small_128_switched",
    "linear_attention_block_v2": "tools",
    "conv3x3": "tools",
    "linear_attention_v4": "tools",
    "transpose2d": "tools",
}
FILM_KERNELS = ("group_norm_silu_film", "group_norm_silu_bm")
TOOL_KERNELS = ("linear_attention_block_v2", "conv3x3", "linear_attention_v4", "transpose2d")
TOOL_REPS, TOOL_ROUNDS = 10, 3  # the tools' timing in phase 7 (their CLI defaults: 50, 5)
EXACT = ("transpose2d",)  # moves bits: held bit for bit
# The tool shape (recorded call key) at which #10-#13 are also held in float32.
TOOL_F32_KEYS = {"linear_attention_block_v2": (128, 256, 64), "linear_attention_v4": (128, 128, 128),
                 "conv3x3": (128, 16, 16, 32, 32), "transpose2d": (4096, 128)}
# #13 also at a shape whose rows are not a multiple of its 128-row tile and
# whose columns are not a whole column tile, in bf16.
TRANSPOSE_RAGGED = (1000, 96)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Kernel names of this repository's CUDA sources, as the profiler reports them.
HAND_KERNELS = (
    "gn_silu_kernel", "linattn_block_kernel", "attn_block_small_kernel",
    "attn_wgmma_kernel", "attn_mma_kernel", "attn_f32_kernel", "gn_bm_kernel",
    "conv3x3_mma_kernel", "conv3x3_wgmma_kernel", "conv3x3_f32_kernel", "transpose2d_kernel",
)
# Kernels a call of which must run exactly this one device kernel (no
# transpose, copy or memset), and repeat bit for bit (redesigned in this
# form: #6 as one launch, #2, #9, #10, #3, #12 and #8 as one cluster launch,
# #1 and #5 as one launch, a sample on a CTA or a cluster).
ONE_LAUNCH = {"group_norm_silu": "gn_silu_kernel", "group_norm_silu_film": "gn_silu_kernel",
              "group_norm_silu_bm": "gn_bm_kernel", "linear_attention_block": "linattn_block_kernel",
              "linear_attention_block_v1": "linattn_block_kernel",
              "linear_attention_block_v2": "linattn_block_kernel",
              "linear_attention_tokens": "linattn_block_kernel",
              "linear_attention_v4": "linattn_block_kernel",
              "linear_attention_qkv": "linattn_block_kernel"}
# Kernels whose device time is also logged by kernel name at every checked
# shape: those above, and #11 (on the tensor cores).
BY_NAME = ("conv3x3",) + tuple(ONE_LAUNCH)
# Kernels held to the TPU kernel's seams in bf16 besides the tolerance: max
# |diff| within one bf16 step at the output's scale (2^-7 max |ref|), at most
# SEAM_DIFFER of the elements differing (rtol = atol = 2e-2 says nothing at
# outputs under 0.1), against the plain version with its sums in float64
# between the same bf16 roundings: the float32 plain version's own summation
# order moves up to 1.9% of #3's elements at [2,4096,256]
# (``tools/check_linattn.py``'s [seeds] lines).
SEAM = ("linear_attention_tokens", "linear_attention_v4", "linear_attention_qkv")
SEAM_DIFFER = 0.02


def fmt(v, digits=4) -> str:
    return "not measured" if v is None else f"{v:.{digits}f}"


# --------------------------------------------------------------- kernel table --
def kernel_table(port):
    """name -> (wrapper module, wrapper attribute, plain version, source, TPU kernel)."""
    A, N, C, T = port.ops.attention, port.ops.norm, port.ops.conv, port.ops.transpose
    return {
        "group_norm_silu": (
            N, "group_norm_silu_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_silu.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:92",
        ),
        "linear_attention_block": (  # the packed TPU kernel's own seams
            A, "linear_attention_block_cuda", A.linear_attention_block_packed_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:842",
        ),
        "linear_attention_tokens": (  # the TPU kernel's own seams
            A, "linear_attention_tokens_cuda", A.linear_attention_tokens_fused_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:660",
        ),
        "attention_block_small": (
            A, "attention_block_small_cuda", A.attention_block_reference,
            "diffusion_model_nemo_tpu_torch/csrc/attention_block_small.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:1103",
        ),
        "linear_attention_qkv": (  # the TPU kernel's own seams: f32 throughout, one cast
            A, "linear_attention_qkv_cuda", A.linear_attention_qkv_fused_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:194",
        ),
        "attention": (
            A, "attention_cuda", A.attention_reference,
            "diffusion_model_nemo_tpu_torch/csrc/attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:57",
        ),
        "group_norm_silu_film": (
            N, "group_norm_silu_film_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_silu.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:101",
        ),
        "group_norm_silu_bm": (
            N, "group_norm_silu_bm_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_bm.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:142",
        ),
        "linear_attention_block_v1": (  # #10's function in bf16: v2's seams
            A, "linear_attention_block_v1_cuda", A.linear_attention_block_v2_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:353",
        ),
        "linear_attention_block_v2": (
            A, "linear_attention_block_v2_cuda", A.linear_attention_block_v2_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:535",
        ),
        "conv3x3": (
            C, "conv3x3_cuda", C.conv3x3_reference,
            "diffusion_model_nemo_tpu_torch/csrc/conv3x3.cu",
            "diffusion_model_nemo_tpu/ops/conv.py:75",
        ),
        "linear_attention_v4": (  # #3's seams on the packed view
            A, "linear_attention_v4_cuda", A.linear_attention_v4_fused_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "tools/microbench_attn_lanes.py:33",
        ),
        "transpose2d": (
            T, "transpose2d_cuda", T.transpose2d_reference,
            "diffusion_model_nemo_tpu_torch/csrc/transpose.cu",
            "tools/microbench_attn_lanes.py:94",
        ),
    }


def copy_arg(a, dtype=None):
    """A copy of a recorded argument that keeps its strides (the DiT's k and
    v are strided slices of its qkv tensor), optionally in another dtype."""
    import torch

    if not torch.is_tensor(a):
        return a
    # Recorded inside a forward, which runs in inference mode: the copy is made
    # a normal tensor, as the served parameters are (it tracks a version, so
    # the wrappers keep what they derive from it, as on the main path).
    with torch.inference_mode(False):
        out = torch.empty_strided(a.size(), a.stride(), dtype=dtype or a.dtype, device=a.device)
        return out.copy_(a)


def call_key(name, args):
    """A recorded call's key: x's shape, and the FiLM scale's shape where
    the GroupNorm call has one, F where the conv has it."""
    key = tuple(args[0].shape)
    if name in FILM_KERNELS and len(args) > 5 and args[5] is not None:
        key += ("film",) + tuple(args[5].shape)
    if name == "conv3x3":
        key += (args[1].shape[-1],)
    return key


def record_calls(port, model, x, t, run=None):
    """One forward (or ``run()``); returns {kernel: {key: [count, copied args]}}."""
    import torch

    table = kernel_table(port)
    calls = {name: {} for name in table}
    with ExitStack() as stack:
        for name, (mod, attr, _plain, _src, _rep) in table.items():
            real = getattr(mod, attr)

            def recorder(*args, _name=name, _real=real):
                key = call_key(_name, args)
                slot = calls[_name].setdefault(key, [0, None])
                slot[0] += 1
                if slot[1] is None:
                    slot[1] = tuple(copy_arg(a) for a in args)
                return _real(*args)

            stack.enter_context(mock.patch.object(mod, attr, recorder))
        if run is None:
            model.forward(x, t)
        else:
            run()
    torch.cuda.synchronize()
    return calls


def plain_path(port):
    """Context in which every kernel wrapper is swapped for its plain version
    (for the reference forward only)."""
    stack = ExitStack()
    for mod, attr, plain, _src, _rep in kernel_table(port).values():
        stack.enter_context(mock.patch.object(mod, attr, plain))
    return stack


def library_fn(name, args):
    """One PyTorch call (or the sdpa composition) computing the same
    function, timed as a yardstick; None where there is none."""
    import torch
    import torch.nn.functional as F

    if name.startswith("group_norm_silu"):
        x, gamma, beta, groups, eps = args[:5]
        g, b = gamma.to(x.dtype), beta.to(x.dtype)
        xc = x.permute(0, 3, 1, 2)
        if len(args) == 5 or args[5] is None:
            return lambda: F.silu(F.group_norm(xc, groups, g, b, eps))
        sc1, sh = ((a.to(x.dtype) + d).permute(0, 3, 1, 2) for a, d in ((args[5], 1), (args[6], 0)))
        return lambda: F.silu(torch.addcmul(sh, F.group_norm(xc, groups, g, b, eps), sc1))
    if name == "attention":
        q, k, v = (a.transpose(1, 2) for a in args)  # [B, h, N, d] views
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    if name == "attention_block_small":
        x, ng, nb, wqkv, wout, bout, heads, dh, scale, eps = args
        Bn, Nn, C = x.shape
        dt = x.dtype
        ng_, nb_, wq, wo, bo = ng.to(dt), nb.to(dt), wqkv.t().to(dt), wout.t().to(dt), bout.to(dt)

        def run():
            h = F.group_norm(x.transpose(1, 2), 1, ng_, nb_, eps).transpose(1, 2)
            qkv = F.linear(h, wq).reshape(Bn, Nn, 3, heads, dh).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=scale)
            return F.linear(o.transpose(1, 2).reshape(Bn, Nn, heads * dh), wo, bo) + x

        return run
    if name == "conv3x3":  # cuDNN on a channels_last view of the NHWC data
        from diffusion_model_nemo_tpu_torch.tools.microbench_conv import library_conv

        return library_conv(*args)
    if name == "transpose2d":
        x = args[0]
        return lambda: x.t().contiguous()
    return None


def agreement(name, wrapper, plain, args):
    """The kernel against its plain version on ``args``: (kernel output as
    float32, max |diff|, tolerance, ok, seam text). rtol = atol = the
    dtype's tolerance (#13 exact); for a SEAM kernel in bf16 also the seam
    check against the plain version with float64 sums."""
    import torch

    tol = 0.0 if name in EXACT else TOL if args[0].dtype == torch.bfloat16 else F32_TOL
    out_k = wrapper(*args).float()
    out_p = plain(*args).float()
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    ok = bool((err <= tol + tol * out_p.abs()).all()) and bool(torch.isfinite(out_k).all())
    seam = ""
    if name in SEAM and args[0].dtype == torch.bfloat16:
        exact = plain(*args, acc=torch.float64).float()
        step = 2.0**-7 * float(exact.abs().max())
        seam_err, differ = float((out_k - exact).abs().max()), float((out_k != exact).float().mean())
        ok &= seam_err <= step and differ <= SEAM_DIFFER
        seam = (f" seam (float64 sums): max_abs_err {seam_err:.3e} <= {step:.3e} (one bf16 step), differ "
                f"{differ:.4f} <= {SEAM_DIFFER} (against the float32 plain version {float((err > 0).float().mean()):.4f})")
    return out_k, float(err.max()), tol, ok, seam


def check_kernels(port, calls_by_cfg):
    import torch

    table = kernel_table(port)
    rows = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0, "shapes": 0,
                   "dev": 0.0, "plain_dev": 0.0, "library_dev": 0.0}
            for name in table}
    for cfg_name, calls in calls_by_cfg.items():
        for name, shapes in calls.items():
            mod, attr, plain, _src, _rep = table[name]
            wrapper = getattr(mod, attr)
            for key, (count, args) in sorted(shapes.items()):
                out_k, max_err, tol, ok, seam = agreement(name, wrapper, plain, args)
                k_ms = time_ms(lambda: wrapper(*args))
                p_ms = time_ms(lambda: plain(*args))
                lib = library_fn(name, args)
                l_ms = time_ms(lib) if lib is not None else None
                d_k = device_ms(lambda: wrapper(*args))
                d_p = device_ms(lambda: plain(*args))
                d_l = device_ms(lib) if lib is not None else None
                nbytes, ops, kind = work(name, args)
                t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
                bound = max(t_bytes, t_ops)
                exp2 = ""
                if name == "attention":  # B h N^2 exponentials
                    Bn, Nn, h, _d = args[0].shape
                    exp2 = f" exp2_bound_ms={Bn * h * Nn * Nn / PEAK_EXP2_PER_S * 1e3:.5f}"
                log(
                    f"[kernel] {cfg_name} {name} {list(key)} {str(args[0].dtype)[6:]} x{count}/forward "
                    f"max_abs_err={max_err:.3e} ok={ok} (tol {tol}){seam} ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={'null' if l_ms is None else f'{l_ms:.4f}'} "
                    f"bound_ms={bound:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}){exp2} "
                    f"device_ms(kernel/plain/library)={fmt(d_k)}/{fmt(d_p)}/"
                    f"{'null' if lib is None else fmt(d_l)}"
                )
                if not ok:
                    raise AssertionError(
                        f"{name} at {list(key)} disagrees with its plain version "
                        f"(max |diff| {max_err:.3e}, rtol=atol={tol}{seam})"
                    )
                if name in BY_NAME:
                    _total, by_name = device_profile(lambda: wrapper(*args))
                    launched = kernel_launches(lambda: wrapper(*args))
                    q_k = queued_us(lambda: wrapper(*args)) / 1e3
                    q_l = None if lib is None else queued_us(lib) / 1e3
                    log(f"[kernel]   {name} {list(key)} device ms by kernel name: "
                        f"{json.dumps({n[:60]: round(v, 5) for n, v in by_name.items()})}; one call runs {launched}; "
                        f"queued events kernel {q_k:.5f} library {'null' if q_l is None else f'{q_l:.5f}'} ms")
                    # One launch, no transpose, copy or memset.
                    if name in ONE_LAUNCH:
                        assert len(launched) == 1 and ONE_LAUNCH[name] in launched[0], (key, launched)
                    if name in ONE_LAUNCH:
                        assert torch.equal(wrapper(*args), out_k.to(args[0].dtype)), f"{name} {key} does not repeat"
                r = rows[name]
                r["max_abs_err"] = max(r["max_abs_err"], max_err)
                r["shapes"] += 1
                if cfg_name == MAIN_CFG[name]:  # per-forward sums on the main path
                    r["ms"] += count * k_ms
                    r["plain_ms"] += count * p_ms
                    r["bound_ms"] += count * bound
                    r["bytes_s"] += count * t_bytes
                    r["ops_s"] += count * t_ops
                    r["dev"] += count * d_k
                    r["plain_dev"] += count * d_p
                    if l_ms is None:
                        r["library_ms"] = r["library_dev"] = None
                    elif r["library_ms"] is not None:
                        r["library_ms"] += count * l_ms
                        r["library_dev"] += count * d_l
    return rows


# --------------------------------------------------------------------- phases --
def redraw_zero_leaves(model, std: float = 0.02) -> None:
    """adaLN-Zero makes a freshly initialised DiT output exactly zero (every
    image constant, every kernel check vacuous): redraw each all-zero leaf
    from a seeded N(0, std²), in params and ema_params alike."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    for name in sorted(model.params):
        p = model.params[name]
        if bool((p == 0).all()):
            draw = (torch.randn(p.shape, generator=g) * std).to(p.device)
            p.copy_(draw)
            model.ema_params[name].copy_(draw)


def build_models(port, device):
    from diffusion_model_nemo_tpu_torch.config import (
        dit_small_model_config, flagship_model_config, unet_small_model_config,
    )

    f32 = unet_small_model_config()
    f32["diffusion_model"]["dtype"] = "float32"
    dit = port.DDPM(dit_small_model_config(), device=device, seed=SEED)
    redraw_zero_leaves(dit)
    return {
        "unet_small": port.DDPM(unet_small_model_config(), device=device, seed=SEED),
        "flagship": port.DDPM(flagship_model_config(), device=device, seed=SEED),
        "unet_small_f32": port.DDPM(f32, device=device, seed=SEED),
        "dit_s2": dit,
    }


def model_inputs(device, size, batch=B):
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(batch, size, size, 3, generator=g, device=device)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device, dtype=torch.int32)
    return x, t


def per_forward_counts(calls):
    """{kernel: launches per forward} for the kernels a forward launched."""
    return {k: n for k, v in calls.items() if (n := sum(c for c, _ in v.values())) > 0}


def derived_calls(calls):
    """Kernel checks beyond the recorded dtypes: #7 at the DiT's shapes in
    float32, #8 in bf16 at the float32 U-Net's N=256 shape."""
    import torch

    att = {k: [c, tuple(copy_arg(a, torch.float32) for a in args)]
           for k, (c, args) in calls["dit_s2"]["attention"].items()}
    lin = {k: [c, (copy_arg(args[0], torch.bfloat16),) + args[1:]]
           for k, (c, args) in calls["unet_small_f32"]["linear_attention_qkv"].items() if k[1] == 256}
    return {"dit_s2_f32": {"attention": att}, "linattn_bf16": {"linear_attention_qkv": lin}}


# ragged N (mma.sync form, then the wgmma form), d=128, N=4096
ATTN_EXTRA_SHAPES = ((2, 1100, 3, 32), (2, 1100, 2, 64), (2, 1024, 2, 128), (1, 4096, 2, 64))
# one padded m16 tile, four, two, and a C that is padded to a multiple of 32
SMALL_BLOCK_EXTRA_SHAPES = ((4, 8, 64), (4, 64, 128), (3, 32, 256), (3, 16, 48))
# The whole-block kernels #2, #9, #10 at the corners of their gates: N = 4096
# resident (C = 32) and in the recompute form (C = 128), a ragged N, one CTA;
# #10 also in float32 in the recompute form. (Phase 7 holds #9, #10 and #12 at
# the microbenchmark's shapes.)
_LINATTN_CORNERS = ((2, 4096, 32), (2, 4096, 128), (3, 100, 128), (2, 64, 128))
LINATTN_EXTRA = {
    "linear_attention_block": [(s, "bf16") for s in _LINATTN_CORNERS],
    "linear_attention_block_v1": [(s, "bf16") for s in _LINATTN_CORNERS],
    "linear_attention_block_v2": [(s, "bf16") for s in _LINATTN_CORNERS] + [((2, 4096, 32), "f32")],
}
# The core mode (#3) at the corners of its gate (64 <= N <= 4096, N % 8 == 0;
# C up to the plan's 1280): resident at N = 4096, its recompute form at C =
# 256, a ragged m16 tile, one CTA.
CORE_EXTRA = ((2, 4096, 32), (2, 4096, 128), (2, 4096, 256), (3, 104, 128), (2, 64, 128))
# #8 (the raw mode) at the corners of its gate (64 <= N <= 4096, N % 8 ==
# 0), in both dtypes: N = 4096 on a cluster of 16 in the reload form, a
# ragged N (N % 16 != 0), one CTA a sample.
QKV_EXTRA = ((2, 4096, 384), (3, 104, 384), (2, 64, 384))
# #1 and #5 beyond the U-Net's sites: float32, B = 1, a cluster holding its
# shares in shared memory (bf16 [1,64,64,128]), a slab beyond a cluster's
# shared memory (bf16 [1,128,128,128], 4 MB: read twice), C = 48.
NORM_EXTRA = (((64, 32, 32, 32), "f32"), ((1, 32, 32, 32), "bf16"), ((1, 64, 64, 128), "bf16"),
              ((1, 128, 128, 128), "bf16"), ((2, 16, 16, 48), "bf16"))


def extra_calls(device):
    """Kernel checks at shapes no network of the smoke sends: #7 in bf16 with
    k and v cut from one [B, N, 3, h, d] qkv tensor as the DiT cuts them,
    #4 at the ends and the middle of its gate, #2, #9, #10, #3 and #8 at the
    corners of theirs. Seeded inputs."""
    import torch

    from diffusion_model_nemo_tpu_torch.tools.check_linattn import block_args

    g = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    att = {}
    for Bn, Nn, h, d in ATTN_EXTRA_SHAPES:
        qkv = randn(Bn, Nn, 3, h, d).to(torch.bfloat16)
        att[(Bn, Nn, h, d)] = [1, (qkv[:, :, 0] * d**-0.5, qkv[:, :, 1], qkv[:, :, 2])]
    small = {}
    for Bn, Nn, C in SMALL_BLOCK_EXTRA_SHAPES:
        small[(Bn, Nn, C)] = [1, (
            randn(Bn, Nn, C, std=0.5).to(torch.bfloat16), 1.0 + randn(C, std=0.1), randn(C, std=0.1),
            randn(C, 384, std=C**-0.5), randn(128, C, std=128**-0.5), randn(C, std=0.1),
            4, 32, 32**-0.5, 1e-5,
        )]
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    block = {name: {(*shape, dt): [1, block_args(shape, dtypes[dt], g, device)] for shape, dt in shapes}
             for name, shapes in LINATTN_EXTRA.items()}
    block["linear_attention_tokens"] = {
        (Bn, Nn, C): [1, (randn(Bn, Nn, C).to(torch.bfloat16), randn(C, 384, std=C**-0.5), 4, 32, 32**-0.5)]
        for Bn, Nn, C in CORE_EXTRA}
    block["linear_attention_qkv"] = {(*shape, dt): [1, (randn(*shape).to(dtypes[dt]), 4, 32, 32**-0.5)]
                                     for shape in QKV_EXTRA for dt in dtypes}
    norm = {"group_norm_silu": {}, "group_norm_silu_film": {}}
    for (Bn, H, W, C), dt in NORM_EXTRA:
        x = randn(Bn, H, W, C).to(dtypes[dt])
        args = (x, 1.0 + randn(C, std=0.1), randn(C, std=0.1), 8, 1e-5)
        film = tuple(randn(Bn, 1, 1, 2 * C, std=0.5).to(dtypes[dt]).chunk(2, dim=-1))
        norm["group_norm_silu"][(Bn, H, W, C, dt)] = [1, args]
        norm["group_norm_silu_film"][(Bn, H, W, C, dt, "film")] = [1, args + film]
    return {"attention_extra": {"attention": att}, "small_block_extra": {"attention_block_small": small},
            "linattn_block_extra": block, "norm_extra": norm}


def log_profile(tag, model, x, t):
    wall = time_ms(lambda: model.forward(x, t), iters=10)
    total, by_name = device_profile(lambda: model.forward(x, t), iters=5)
    hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {tag} forward B={B}: wall {wall:.3f} ms (CUDA events), device busy "
        f"{total:.3f} ms ({100 * total / wall:.1f}%), hand kernels {hand:.3f} ms, "
        f"other {total - hand:.3f} ms in {len(by_name)} kernel names")
    for n, v in top:
        log(f"[profile]   {v:.4f} ms  {n[:110]}")


def check_forward(port, name, model, x, t, tol):
    """Forward with kernels against the plain path: relative L2 <= tol."""
    import torch

    out_k = model.forward(x, t)
    with plain_path(port):
        out_p = model.forward(x, t)
    torch.cuda.synchronize()
    rel = float((out_k - out_p).norm() / out_p.norm())
    max_abs = float((out_k - out_p).abs().max())
    finite = bool(torch.isfinite(out_k).all())
    std = float(out_k.std())
    log(f"[forward] {name} B={x.shape[0]} kernels vs plain: rel_l2={rel:.3e} max_abs={max_abs:.3e} "
        f"finite={finite} std={std:.4f} shape={list(out_k.shape)} (tol rel_l2 <= {tol})")
    if not finite or rel > tol or tuple(out_k.shape) != tuple(x.shape) or not std > 0:
        raise AssertionError(f"{name} forward with kernels disagrees with the plain path")


def check_networks(port, models, inputs):
    """Phase 3 for the bf16 networks: U-Nets and DiT-S/2."""
    log_profile("unet_small", models["unet_small"], *inputs["unet_small"])
    log_profile("dit_s2", models["dit_s2"], *inputs["dit_s2"])
    for name in ("unet_small", "flagship", "dit_s2"):
        check_forward(port, name, models[name], *inputs[name], UNET_REL_TOL)


def check_float32_route(port, model, x, t, per_forward):
    """float32 on CUDA: the GroupNorm kernel takes f32 and agrees with its
    plain version; the float32 unet_small forward agrees with its plain path
    and launches kernel #8 five times (down 0-2, up 1-2); a 10-step DDIM
    chain launches it 5 x 10 times. Returns the chain's launch counts."""
    import torch

    g = torch.Generator(device=x.device).manual_seed(SEED)
    xs = torch.randn(B, 32, 32, 32, generator=g, device=x.device)
    gamma = 1.0 + 0.1 * torch.randn(32, generator=g, device=x.device)
    beta = 0.1 * torch.randn(32, generator=g, device=x.device)
    out_k = port.ops.norm.group_norm_silu_cuda(xs, gamma, beta, 8)
    out_p = port.ops.norm.group_norm_silu_reference(xs, gamma, beta, 8)
    err = float((out_k - out_p).abs().max())
    log(f"[f32] group_norm_silu float32 [64, 32, 32, 32]: max_abs_err={err:.3e} (tol {F32_TOL})")
    assert err <= F32_TOL, err
    assert per_forward.get("linear_attention_qkv") == 5, per_forward
    port.ops.reset_launch_counts()
    model.forward(x, t)
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    log(f"[f32] unet_small float32 forward launches: {counts}")
    assert all(counts[k] == per_forward.get(k, 0) for k in counts), (counts, per_forward)
    check_forward(port, "unet_small_f32", model, x, t, F32_REL_TOL)

    steps = 10
    sampler_cfg = dict(model.cfg.sampler, eta=0.0, ddim_timesteps=steps,
                       _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion")
    model.change_sampler(sampler_cfg)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.sample(B, 32, generator=torch.Generator(device=x.device).manual_seed(SEED))
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    finite = bool(torch.isfinite(out).all())
    log(f"[f32] DDIM-{steps} float32 unet_small B={B}: {time.perf_counter() - t0:.3f} s, "
        f"finite={finite}, std={float(out.std()):.4f}, launches={counts}")
    assert finite and tuple(out.shape) == (B, 32, 32, 3) and float(out.std()) > 0
    assert all(counts[k] == per_forward.get(k, 0) * steps for k in counts), (counts, per_forward)
    return counts


def http(method, url, payload=None, timeout=600):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def check_serving(port, tag, model, per_forward, max_batch, size):
    """/healthz, concurrent png + npy requests, one seed twice, /stats; every
    kernel's launches equal per-forward x DDIM_STEPS x batches (0 off the path)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, port=0, max_batch=max_batch, ddim_timesteps=DDIM_STEPS, use_ema=True)
    log(f"[serve] {tag} DDIM-{DDIM_STEPS} max_batch={max_batch} warm-up batch "
        f"{time.perf_counter() - t0:.2f} s")
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        code, body = http("GET", base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok" and health["warm"], health
        results = {}

        def request(key, payload):
            results[key] = http("POST", base + "/sample", payload)

        t1 = time.perf_counter()
        threads = [
            threading.Thread(target=request, args=("png", {"num_images": 5, "format": "png"})),
            threading.Thread(target=request, args=("npy", {"num_images": 40, "format": "npy"})),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            assert not th.is_alive(), "a concurrent request did not finish"
        request("seed_a", {"num_images": 3, "seed": 1234, "format": "npy"})
        request("seed_b", {"num_images": 3, "seed": 1234, "format": "npy"})
        wall = time.perf_counter() - t1
        code, body = http("GET", base + "/stats")
        stats = json.loads(body)
    finally:
        server.shutdown()

    assert all(r[0] == 200 for r in results.values()), {k: r[0] for k, r in results.items()}
    pngs = json.loads(results["png"][1])["images"]
    assert len(pngs) == 5
    for p in pngs:
        img = decode_png(base64.b64decode(p))
        assert img.shape == (size, size, 3) and img.dtype == np.uint8, img.shape
    npy = np.load(io.BytesIO(results["npy"][1]))
    assert npy.shape == (40, size, size, 3) and npy.dtype == np.uint8, (npy.shape, npy.dtype)
    a = np.load(io.BytesIO(results["seed_a"][1]))
    b = np.load(io.BytesIO(results["seed_b"][1]))
    assert a.shape == (3, size, size, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b), "the seeded request did not repeat bit for bit"
    assert npy.std() > 0, "served images are constant"

    counts = port.ops.launch_counts()
    # The served chain is a replay of the sampler's captured chain: the seeded
    # request's images equal the eager Python loop's on the same seed.
    import torch

    from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor

    eager = model.sample(max_batch, size, generator=torch.Generator(device=model.device).manual_seed(1234),
                         use_ema=True, graphs=False)
    eager = to_uint8_tensor(eager)[:3].cpu().numpy()
    assert np.array_equal(a, eager), f"{tag}: the served seeded request differs from the eager chain"
    log(f"[serve] {tag} seeded request (graph replays) == the eager DDIM-{DDIM_STEPS} chain bit for bit")
    batches = stats["batches"] + 1  # + the warm-up batch
    images = stats["images"]
    log(f"[serve] {tag} stats={json.dumps(stats)}")
    log(f"[serve] {tag} {stats['requests']} requests, {images} images in {wall:.3f} s: "
        f"{images / wall:.2f} images/s requested, {max_batch * stats['batches'] / wall:.2f} images/s "
        f"computed, mean latency {stats['avg_request_latency_ms']:.1f} ms; seeded repeat bit-exact")
    for name, n in counts.items():
        per = per_forward.get(name, 0)
        expect = per * DDIM_STEPS * batches
        log(f"[serve] {tag} launches {name}: {n} (expected {per}/forward x {DDIM_STEPS} x {batches})")
        assert n == expect, (name, n, expect)
    assert all(counts[name] > 0 for name in per_forward), counts
    return counts


def check_ancestral(port, model, per_forward):
    import torch

    steps = 10
    sampler_cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    sampler_cfg["_target_"] = "diffusion_model_nemo.modules.GaussianDiffusion"
    model.change_sampler(sampler_cfg)
    port.ops.reset_launch_counts()
    g = torch.Generator(device=model.device).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model.sampler.p_sample_loop(
            model.get_model_fn(), model.params, (B, 32, 32, 3), g, num_steps=steps
        )
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    finite = bool(torch.isfinite(out).all())
    log(f"[ancestral] p_sample_loop(num_steps={steps}) B={B}: {time.perf_counter() - t0:.3f} s, "
        f"finite={finite}, shape={list(out.shape)}, launches={counts}")
    assert finite and tuple(out.shape) == (B, 32, 32, 3)
    for name, n in counts.items():
        assert n == per_forward.get(name, 0) * steps, (name, n, per_forward.get(name, 0) * steps)


# --------------------------------------------------------- the training slice --
def switches(env):
    """The JAX package's opt-in switches, read by the port at call time."""
    return mock.patch.dict(os.environ, env)


def kernel_name(kernel) -> str:
    return kernel.__name__.removesuffix("_cuda")


def derived_counts(port, model, B, size):
    """Launches per forward the gates choose at this batch under the current
    switches: a shapes-only forward of the same network on meta tensors,
    every differentiable kernel call recorded by its wrapper's name."""
    import torch

    cfg = model.network_config()
    channels = cfg.get("in_channels", 3)  # SR3's takes [x_t, up(LR)]
    net = port.config.get_target(cfg.pop("_target_"))(**cfg).to("meta")
    counts = {}

    def record(kernel, plain, *args):
        counts[kernel_name(kernel)] = counts.get(kernel_name(kernel), 0) + 1
        return plain(*args)

    with mock.patch.object(port.ops.norm, "kernel_call", record), \
            mock.patch.object(port.ops.attention, "kernel_call", record):
        net(torch.empty(B, size, size, channels, device="meta"), torch.empty(B, dtype=torch.int32, device="meta"))
    return counts


def assert_counts(tag, counts, expect):
    full = {k: expect.get(k, 0) for k in counts}
    log(f"[train] {tag} launches {json.dumps({k: v for k, v in counts.items() if v})} "
        f"(expected {json.dumps({k: v for k, v in full.items() if v})})")
    assert counts == full, (tag, counts, full)


def check_switched_forwards(port, models, inputs):
    """6a: unet_small and flagship at B=128 under each switch: launches per
    forward equal the gates' derivation; output against the plain path."""
    import torch

    derived = {}
    for name in ("unet_small", "flagship"):
        model, (x, t) = models[name], inputs[name]
        for tag, env in (("NORM_BM", NORM_BM), ("LINATTN_BLOCK", LINATTN_BLOCK)):
            with switches(env):
                expect = derived_counts(port, model, x.shape[0], x.shape[1])
                port.ops.reset_launch_counts()
                model.forward(x, t)
                torch.cuda.synchronize()
                assert_counts(f"{name} B={x.shape[0]} {tag} forward", port.ops.launch_counts(), expect)
                check_forward(port, f"{name} {tag}", model, x, t, UNET_REL_TOL)
            derived[(name, tag)] = expect
    return derived


class FilmPath:
    """``Block(x, scale_shift)`` at each GroupNorm site of a network: per
    site a bf16 conv3x3 -> GroupNorm -> FiLM -> SiLU block whose per-sample
    (scale, shift) [B, 1, 1, C] come from a time MLP (Dense of a sinusoidal
    embedding), seeded random weights. One pass = every site once, forward,
    then the backward of the mean square of the outputs."""

    def __init__(self, port, sites, device):
        import torch

        parts = port.modules.parts
        self.ops = port.ops
        g = torch.Generator().manual_seed(SEED)
        dg = torch.Generator(device=device).manual_seed(SEED)
        self.sites = []
        for (Bn, H, W, C) in sites:
            block = parts.Block(C, C, groups=8, dtype=torch.bfloat16)
            mlp = parts.Dense(128, 2 * C, dtype=torch.bfloat16)
            block.proj.reset_parameters(g)
            mlp.reset_parameters(g)
            x = torch.randn(Bn, H, W, C, generator=dg, device=device).to(torch.bfloat16)
            self.sites.append((block.to(device), mlp.to(device), x))
        self.temb = parts.SinusoidalPositionEmbeddings(128)(
            torch.randint(0, 1000, (sites[0][0],), generator=dg, device=device))

    def forward(self):
        outs = []
        for block, mlp, x in self.sites:
            scale, shift = mlp(self.temb)[:, None, None, :].chunk(2, dim=-1)
            outs.append(block(x, (scale, shift)))
        return outs

    def run(self):
        """Forward and backward; returns (outputs, launches in the forward,
        launches in the backward)."""
        import torch

        self.ops.reset_launch_counts()
        outs = self.forward()
        torch.cuda.synchronize()
        fwd = self.ops.launch_counts()
        loss = sum(o.float().square().mean() for o in outs)
        self.ops.reset_launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        return outs, fwd, self.ops.launch_counts()


def check_film_path(port, path):
    """6b: the FiLM Block pass with kernels against the plain path; #5 at
    every site (#6 at the batch-minor ones under NORM_BM); no launch in the
    backward. Returns the launches of its main run (the forward)."""
    import torch

    sites = [tuple(x.shape) for _b, _m, x in path.sites]
    out_k, fwd, bwd = path.run()
    assert_counts("FiLM Block pass forward", fwd, {"group_norm_silu_film": len(sites)})
    assert_counts("FiLM Block pass backward", bwd, {})
    with plain_path(port):
        out_p = path.forward()
    k = torch.cat([o.detach().float().flatten() for o in out_k])
    p = torch.cat([o.float().flatten() for o in out_p])
    rel = float((k - p).norm() / p.norm())
    log(f"[train] FiLM Block pass ({len(sites)} sites, B={sites[0][0]}) kernels vs plain: rel_l2={rel:.3e} "
        f"(tol {UNET_REL_TOL}), finite={bool(torch.isfinite(k).all())}")
    assert rel <= UNET_REL_TOL and bool(torch.isfinite(k).all())
    with switches(NORM_BM):
        n_bm = sum(port.ops.norm.use_norm_bm(s, torch.bfloat16, s[0] * s[3]) for s in sites)
        _out, fwd_bm, bwd_bm = path.run()
    assert_counts("FiLM Block pass under NORM_BM forward", fwd_bm,
                  {"group_norm_silu_bm": n_bm, "group_norm_silu_film": len(sites) - n_bm})
    assert_counts("FiLM Block pass under NORM_BM backward", bwd_bm, {})
    return fwd


def training_batch(model, B):
    """A synthetic uint8 batch (images and labels) and seeded draws for one
    training step."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset

    ds = SyntheticVisionDataset(image_size=32, channels=3, length=B, seed=SEED)
    batch = {k: np.stack([ds[i][k] for i in range(B)]) for k in ("image", "label")}
    draws = model.draw_training_inputs(batch["image"].shape, torch.Generator(device=model.device).manual_seed(SEED))
    return batch, draws


def step_loss_and_grads(port, model, batch, draws):
    """(loss, flat gradient, launches in the forward, in the backward, the
    step's metrics as floats)."""
    import torch

    from diffusion_model_nemo_tpu_torch.training.trainer import param_grads

    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    port.ops.reset_launch_counts()
    loss, metrics = model.training_step(params, batch, draws)
    torch.cuda.synchronize()
    fwd = port.ops.launch_counts()
    port.ops.reset_launch_counts()
    grads = param_grads(loss, params, getattr(model.diffusion_model, "unused_params", frozenset()))
    torch.cuda.synchronize()
    bwd = port.ops.launch_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    return float(loss), torch.cat([g.float().flatten() for g in grads.values()]), fwd, bwd, metrics


def check_training_step(port, model, per_forward):
    """6c: one unet_small training step at B=128, kernels against the plain
    path from the same weights and draws."""
    batch, draws = training_batch(model, TRAIN_B)
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts("training step forward", fwd, per_forward)
    assert_counts("training step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _, _, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_grad = float((g_k - g_p).norm() / g_p.norm())
    log(f"[train] unet_small step B={TRAIN_B}: loss kernels {loss_k:.6f} plain {loss_p:.6f} "
        f"(rel {rel_loss:.3e}, tol {LOSS_REL_TOL}); whole gradient ({g_k.numel()} values) rel_l2="
        f"{rel_grad:.3e} (tol {GRAD_REL_TOL}), |g| {float(g_k.norm()):.4f}")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    return batch, draws


def training_kernel_costs(port, model, batch, draws):
    """Per kernel call of one training step: the kernel's time (forward)
    against its backward, which recomputes the plain version and
    differentiates it (CUDA events, summed over the step's calls)."""
    import torch

    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    calls = record_calls(port, None, None, None, run=lambda: model.training_step(params, batch, draws))
    table = kernel_table(port)
    fwd_total = bwd_total = 0.0
    for name, shapes in calls.items():
        mod, attr, plain, _src, _rep = table[name]
        for key, (count, args) in sorted(shapes.items()):
            kernel = getattr(mod, attr)
            leaves = [a.detach().requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point() else a
                      for a in args]
            wrt = [a for a in leaves if torch.is_tensor(a) and a.requires_grad]
            out = plain(*leaves)
            cot = torch.randn_like(out)

            def backward():
                with torch.enable_grad():
                    torch.autograd.grad(plain(*leaves), wrt, cot)

            k_ms, b_ms = time_ms(lambda: kernel(*args)), time_ms(backward)
            fwd_total += count * k_ms
            bwd_total += count * b_ms
            log(f"[train-cost] {name} {list(key)} x{count}/step kernel {k_ms:.4f} ms, "
                f"backward (plain recompute + vjp) {b_ms:.4f} ms")
    log(f"[train-cost] per step at B={TRAIN_B}: hand kernels {fwd_total:.3f} ms (forward), their "
        f"backwards {bwd_total:.3f} ms (CUDA events, call by call)")
    return fwd_total, bwd_total


def check_fit(port, device, steps, env, expect_per_step, model=None):
    """6d: ``Trainer.fit`` of unet_small (or of ``model``) at B=128 on the
    synthetic set."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    if model is None:
        cfg = unet_small_model_config()
        cfg["train_ds"]["name"] = "synthetic"
        model = port.DDPM(cfg, device=device, seed=SEED)
    ema0 = {k: v.clone() for k, v in model.ema_params.items()}
    trainer = port.Trainer(max_steps=steps, log_every_n_steps=5, devices=1, seed=SEED)
    states, init_state = [], trainer.init_state
    trainer.init_state = lambda m, n: states.append(init_state(m, n)) or states[-1]
    with switches(env):
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = port.ops.launch_counts()
    tag = "+".join(env) or "default routes"
    losses = [m["train_loss"] for m in trainer.logged]
    moved = max(float((model.ema_params[k] - ema0[k]).abs().max()) for k in ema0)
    log(f"[train] fit {steps} steps B={TRAIN_B} ({tag}): {wall:.2f} s with set-up; logged "
        f"{json.dumps(trainer.logged)}; EMA moved max |d| {moved:.3e}")
    assert len(losses) == steps // 5 and all(map(lambda v: v == v and abs(v) < 1e6, losses)), losses
    assert moved > 0
    assert_counts(f"fit {steps} steps ({tag})", counts, {k: v * steps for k, v in expect_per_step.items()})
    check_derived_weights(port, model, states[0].params, tag)
    return model, trainer, counts


def check_derived_weights(port, model, params, tag):
    """After training: what each attention layer's kernel derives from its
    parameters (the prenorm fold, casts, re-layouts; kept per parameter
    version) equals, for the very tensors the optimizer updated in place, a
    fresh derivation bit for bit."""
    import torch

    A = port.ops.attention
    parts = port.modules.parts
    layers = 0
    for name, mod in model.diffusion_model.named_modules():
        if not isinstance(mod, parts.SelfAttentionBlock):
            continue
        ng, nb = params[f"{name}.norm.weight"], params[f"{name}.norm.bias"]
        wqkv, wout = params[f"{name}.attn.to_qkv.weight"].t(), params[f"{name}.attn.to_out.weight"].t()
        bout = params[f"{name}.attn.to_out.bias"]

        def derive():
            if mod.linear:  # #2 (folded), #9 (unfolded), #3
                return tuple(t for folded in (True, False)
                             for t in A._linattn_block_weights(folded, torch.bfloat16, ng, nb, wqkv, wout)
                             if t is not None) + (A._linattn_core_weights(wqkv, torch.bfloat16),)
            return A._small_block_weights(ng, nb, wqkv, wout, bout)

        with torch.no_grad():
            kept = derive()
            with mock.patch.object(A._derived, "enabled", False):
                fresh = derive()
        assert all(torch.equal(a, b) for a, b in zip(kept, fresh)), f"stale derived weights at {name}"
        layers += 1
    log(f"[train] fit ({tag}): derived weights of {layers} attention layers equal a fresh derivation "
        f"bit for bit; cache {A._derived.stats()}")
    assert layers > 0


def step_profile(port, model):
    """Wall time per optimizer step (CUDA events over 20 steps), device busy
    per step (torch.profiler) and its share: the captured step (replays),
    then the eager step on a state of its own."""
    batch, draws = training_batch(model, TRAIN_B)
    for graphs in (None, False):
        trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
        state = trainer.init_state(model, TRAIN_STEPS)
        run = lambda: trainer.train_step(model, state, batch, draws, graphs=graphs)  # noqa: E731
        wall = time_ms(run, iters=20)
        total, by_name = device_profile(run, iters=5)
        hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
        tag = "captured (graph replays)" if graphs is None else "eager"
        log(f"[train] step B={TRAIN_B} {tag}: wall {wall:.3f} ms (CUDA events), {TRAIN_B / wall * 1e3:.1f} "
            f"samples/s; device busy {total:.3f} ms ({100 * total / wall:.1f}%; wall / busy "
            f"{wall / total:.2f}), hand kernels {hand:.3f} ms, other {total - hand:.3f} ms in "
            f"{len(by_name)} kernel names")
        for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[train]   {v:.4f} ms  {n[:110]}")
        if graphs is None:
            info = graph_of(state.graphs, "train_step").info
            log(f"[graph] train_step B={TRAIN_B}: capture {info['capture_s']:.3f} s, {info['nodes']} nodes, "
                f"pool {info['pool_mib']:.1f} MiB, launches a replay {json.dumps(info['launches'])}")


# ------------------------------------------------------------- the tools path --
def run_tools():
    """The three kernel microbenchmarks at their full shapes; their rows."""
    from diffusion_model_nemo_tpu_torch.tools import microbench_attn, microbench_attn_lanes, microbench_conv

    rows = []
    for tool in (microbench_attn, microbench_conv, microbench_attn_lanes):
        t0 = time.perf_counter()
        tool_rows = tool.run(device="cuda", reps=TOOL_REPS, rounds=TOOL_ROUNDS)
        log(f"[tool] {tool.__name__.rsplit('.', 1)[-1]} (reps={TOOL_REPS}, rounds={TOOL_ROUNDS}, "
            f"{time.perf_counter() - t0:.1f} s; {card_line()}):")
        for line in tool.report(tool_rows):
            log(f"[tool]   {line}")
        rows += tool_rows
    return rows


def check_tools(port):
    """Phase 7: the tools path. Returns (kernel rows of #10-#13, launches in
    the tools' run, launches per pass over the tool shapes)."""
    import torch

    rows = []
    port.ops.reset_launch_counts()
    calls = record_calls(port, None, None, None, run=lambda: rows.extend(run_tools()))
    counts = port.ops.launch_counts()
    made = {name: sum(c for c, _ in v.values()) for name, v in calls.items()}
    log(f"[tool] launches in the tools' run: {json.dumps({k: v for k, v in counts.items() if v})} "
        f"(calls the tools made: {json.dumps({k: v for k, v in made.items() if v})})")
    assert counts == made, (counts, made)
    assert all(counts[name] > 0 for name in TOOL_KERNELS), counts
    assert all(r["exact"] for r in rows if r["arm"] == "transpose"), "kernel #13 is not bit for bit"
    assert all(r["us"] > 0 for r in rows), rows
    # One call per shape the tools gave each kernel (one pass over the tool
    # shapes), #10-#13 in float32 at one shape each, and #13 at a ragged shape.
    # #9 is also held (against v2's seams) at the shapes microbench_attn gives it.
    per_shape = {name: {k: [1, args] for k, (_c, args) in calls[name].items()}
                 for name in TOOL_KERNELS + ("linear_attention_block_v1",)}
    assert len(per_shape["linear_attention_block_v1"]) == 2, per_shape["linear_attention_block_v1"].keys()
    f32 = {name: {key: [1, tuple(copy_arg(a, torch.float32) for a in per_shape[name][key][1])]}
           for name, key in TOOL_F32_KEYS.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ragged = torch.randn(*TRANSPOSE_RAGGED, generator=gen, device="cuda").to(torch.bfloat16)
    checked = check_kernels(port, {"tools": per_shape, "tools_f32": f32,
                                   "tools_ragged": {"transpose2d": {TRANSPOSE_RAGGED: [1, (ragged,)]}}})
    per_pass = {name: len(per_shape[name]) for name in TOOL_KERNELS}
    tool_sums = {k: sum(r["us"] for r in rows if r["tool"] == "microbench_conv" and r["arm"] == arm)
                 for k, arm in (("kernel", "conv3x3"), ("cudnn", "cudnn"))}
    log(f"[tool] conv3x3 over the six tool shapes (CUDA events, the tool's median): kernel "
        f"{tool_sums['kernel']:.2f} us, cuDNN {tool_sums['cudnn']:.2f} us")
    v1_err = checked["linear_attention_block_v1"]["max_abs_err"]
    return {name: checked[name] for name in TOOL_KERNELS}, counts, per_pass, v1_err


def check_tap_split_backward(port, device):
    """Phase 7: ``conv3x3_tap_split`` under ``DMN_TPU_TAP_SPLIT_CONV=1`` at the
    level-0 tool shape launches #11 once in the forward and nothing in the
    backward (the plain conv's recompute), with gradients equal to autograd
    through the plain conv (relative L2, bf16)."""
    import torch

    from diffusion_model_nemo_tpu_torch.tools.microbench_conv import inputs

    C = port.ops.conv
    args = inputs((128, 32, 32, 32, 32), device)
    cot = torch.randn(128, 32, 32, 32, generator=torch.Generator(device=device).manual_seed(SEED),
                      device=device).to(torch.bfloat16)

    def grads(fn):
        leaves = [a.detach().requires_grad_(True) for a in args]
        port.ops.reset_launch_counts()
        out = fn(*leaves)
        torch.cuda.synchronize()
        fwd = port.ops.launch_counts()
        port.ops.reset_launch_counts()
        g = torch.autograd.grad(out, leaves, cot)
        torch.cuda.synchronize()
        return g, fwd, port.ops.launch_counts()

    with switches({"DMN_TPU_TAP_SPLIT_CONV": "1"}):
        g_k, fwd, bwd = grads(C.conv3x3_tap_split)
    assert_counts("conv3x3_tap_split [128,32,32,32->32] forward", fwd, {"conv3x3": 1})
    assert_counts("conv3x3_tap_split [128,32,32,32->32] backward", bwd, {})
    g_p, _f, _b = grads(C.conv3x3_reference)
    rel = [float((a.float() - b.float()).norm() / b.float().norm()) for a, b in zip(g_k, g_p)]
    log(f"[tool] conv3x3_tap_split gradients (x, w, b) vs autograd through the plain conv: rel_l2 "
        f"{', '.join(f'{r:.3e}' for r in rel)} (tol {LOSS_REL_TOL})")
    assert all(r <= LOSS_REL_TOL for r in rel), rel


# ------------------------------------------------- the README's usage path --
class Stopwatch:
    """Card-synchronised seconds spent in wrapped methods, by name."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, stack, owner, attr, name=None):
        import torch

        real = getattr(owner, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds.setdefault(name or attr, []).append(time.perf_counter() - t0)

        stack.enter_context(mock.patch.object(owner, attr, timed))


def cli_counts(port, tag, must, exact=None):
    """The launches since the last reset: each kernel of ``must`` ran, and
    those of ``exact`` the given number of times."""
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    log(f"[cli] {tag} launches {json.dumps(counts)}")
    missing = [k for k in must if not counts.get(k)]
    assert not missing, f"{tag}: {missing} never launched"
    for k, n in (exact or {}).items():
        assert counts.get(k) == n, (tag, k, counts.get(k), n)


def bpd_equal(a, b):
    import torch

    return torch.equal(a["total_bpd"], b["total_bpd"]) and torch.equal(a["terms_bpd"], b["terms_bpd"])


def check_bpd_replays(dtype, run_bpd, replayed):
    """Bits/dim's graph replays against the eager loop, bit for bit. In
    float32 cuDNN's convolutions (TF32 off) are not reproducible from run to
    run (eager against eager differs), so there both run with
    ``cudnn.deterministic`` (a setting that keys the graph: it is captured
    anew), and the eager runs' own difference is printed."""
    import torch

    if dtype == "bfloat16":
        same, note = bpd_equal(replayed, run_bpd(False)), ""
    else:
        a, b = run_bpd(False), run_bpd(False)
        ee = float((a["total_bpd"] - b["total_bpd"]).abs().max())
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            same = bpd_equal(run_bpd(), run_bpd(False))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        note = (f" under cudnn.deterministic (eager against eager without it: bit-equal {bpd_equal(a, b)}, "
                f"total_bpd max |diff| {ee:.3e})")
    log(f"[graph] bpd {dtype} T={CLI_BPD_T} B={CLI_TEST_B}: graph replays == the eager loop bit for bit "
        f"(total_bpd, terms_bpd): {same}{note}")
    assert same, f"bits/dim {dtype}: the replayed loop differs from the eager loop"


def check_cli_path(port, device, per_forward, tmp):
    """8. The README's usage path through the port's CLIs, in ``tmp``."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.cli import eval_ddpm, serve as serve_cli, test_ddpm, train_ddpm
    from diffusion_model_nemo_tpu_torch.config import load_config
    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset, preprocess_batch
    from diffusion_model_nemo_tpu_torch.training import CheckpointManager, ExpManagerHooks, Trainer
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png, to_uint8

    unet = ("group_norm_silu", "linear_attention_block", "linear_attention_tokens", "attention_block_small")
    base = [*CLI_CONFIG, *CLI_MODEL, "model.train_ds.name=synthetic", f"model.save_every={CLI_EVERY}",
            "model.compute_bpd=false", f"exp_manager.checkpoint_every_n_steps={CLI_EVERY}",
            f"exp_manager.exp_dir={tmp}/exp", "+exp_manager.version=run"]

    # 8a. train_ddpm: 20 steps at B=128, a dump and a checkpoint every 10.
    watch, saved = Stopwatch(), []
    real_save = CheckpointManager.save

    def record_save(mgr, step, *a, **k):
        wrote = real_save(mgr, step, *a, **k)
        if wrote:
            saved.append(step)
        return wrote

    with ExitStack() as stack:
        watch.wrap(stack, Trainer, "fit")
        watch.wrap(stack, Trainer, "_sample_dump")
        watch.wrap(stack, ExpManagerHooks, "maybe_checkpoint")
        watch.wrap(stack, ExpManagerHooks, "finalize")
        stack.enter_context(mock.patch.object(CheckpointManager, "save", record_save))
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, trainer = train_ddpm.main([*base, f"trainer.max_steps={CLI_STEPS}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cli_counts(port, "train", unet)
    sec = {k: sum(v) for k, v in watch.seconds.items()}
    steps_s = sec["fit"] - sec["_sample_dump"] - sec["maybe_checkpoint"] - sec["finalize"]
    log(f"[cli] train {CLI_STEPS} steps B={TRAIN_B}: {wall:.2f} s in all; fit {sec['fit']:.2f} s = steps "
        f"{steps_s:.2f} s ({steps_s / CLI_STEPS * 1e3:.1f} ms a step with set-up) + {len(watch.seconds['_sample_dump'])} "
        f"sample dumps {sec['_sample_dump']:.2f} s (1000-step ancestral chain, batch 4) + checkpoints "
        f"{sec['maybe_checkpoint']:.2f} s + final checkpoint and archive {sec['finalize']:.2f} s")
    run = trainer.exp_manager_hooks.log_dir
    dumps = sorted(Path(model._result_dir).glob("sample-*.png"))
    assert [p.name for p in dumps] == ["sample-1-1.png", "sample-2-1.png"], dumps
    grid = decode_png(dumps[0].read_bytes())
    assert grid.shape == (CLI_IMG + 4, 4 * (CLI_IMG + 2) + 2, 3) and grid.std() > 0, grid.shape
    assert saved == [CLI_EVERY, CLI_STEPS], saved
    assert CheckpointManager(str(run / "checkpoints")).latest_step() == CLI_STEPS
    dmn = run / "DDPM-UNet.dmn"
    logged = [m["global_step"] for m in trainer.logged]  # the YAML logs every 10 steps, and the last
    assert dmn.is_file() and logged == sorted({*range(10, CLI_STEPS + 1, 10), CLI_STEPS}), logged
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)

    # 8b. resume to 30 from the checkpoint at 20.
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, trainer = train_ddpm.main([*base, f"trainer.max_steps={CLI_RESUME_STEPS}",
                                      "exp_manager.resume_if_exists=true"])
    torch.cuda.synchronize()
    cli_counts(port, "resume", unet)
    hooks = trainer.exp_manager_hooks
    assert hooks.log_dir == run and hooks.resume_state["step"] == CLI_STEPS
    assert [m["global_step"] for m in trainer.logged] == [CLI_RESUME_STEPS], trainer.logged
    assert CheckpointManager(str(run / "checkpoints")).latest_step() == CLI_RESUME_STEPS
    log(f"[cli] resume {CLI_STEPS} -> {CLI_RESUME_STEPS}: {time.perf_counter() - t0:.2f} s with a dump; "
        f"loss {trainer.logged[-1]['train_loss']:.5f}")

    # 8c. The archive round trip: the same forward, bit for bit.
    x, t = model_inputs(device, CLI_IMG)
    t0 = time.perf_counter()
    model.save_to(str(Path(tmp) / "again.dmn"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = port.DDPM.restore_from(str(dmn), device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = torch.equal(restored.forward(x, t), model.forward(x, t))
    log(f"[cli] archive {dmn.stat().st_size / 2**20:.2f} MiB: save {save_s:.3f} s, restore {restore_s:.3f} s "
        f"(restore_from, cuda); restored forward == trained forward bit for bit: {same}")
    assert same

    # 8d. eval_ddpm: DDIM-50 at batch 64; the PNGs are DDPM.sample's images.
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eval_ddpm.main([f"model_path={dmn}", f"batch_size={CLI_EVAL_B}", f"ddim_timesteps={CLI_DDIM}", "seed=0",
                          f"output_dir={tmp}/samples", "add_timestamp=false"])
    eval_s = time.perf_counter() - t0
    cli_counts(port, "eval", unet)
    pngs = np.stack([decode_png((out / f"sample_{i}.png").read_bytes()) for i in range(CLI_EVAL_B)])
    ref_model = port.DDPM.restore_from(str(dmn), use_ema=True, device=device)
    eval_ddpm.maybe_use_ddim_sampler(ref_model, eval_ddpm.EvalConfig(ddim_timesteps=CLI_DDIM))
    t0 = time.perf_counter()
    ref = ref_model.sample(CLI_EVAL_B, CLI_IMG, generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    ref = to_uint8(ref.float().cpu().numpy())
    log(f"[cli] eval DDIM-{CLI_DDIM} B={CLI_EVAL_B}: {eval_s:.2f} s with restore and PNGs ({CLI_EVAL_B / eval_s:.2f} "
        f"images/s); DDPM.sample alone {sample_s:.2f} s ({CLI_EVAL_B / sample_s:.2f} images/s); PNGs == "
        f"DDPM.sample: {np.array_equal(pngs, ref)}")
    assert pngs.shape == (CLI_EVAL_B, CLI_IMG, CLI_IMG, 3) and np.array_equal(pngs, ref) and pngs.std() > 0

    # 8e. test_ddpm: bits/dim of one batch of 32 at T = 1000.
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = test_ddpm.main([f"model_path={dmn}", "limit_test_batches=1", f"batch_size={CLI_TEST_B}"])
    torch.cuda.synchronize()
    bpd_s = time.perf_counter() - t0
    T = int(ref_model.timesteps)
    cli_counts(port, "bpd", unet, exact={"group_norm_silu": T * per_forward["group_norm_silu"]})
    log(f"[cli] bpd test_total_bpd={result['test_total_bpd']:.5f} (terms {result['test_terms_bpd']:.5f}, prior "
        f"{result['test_prior_bpd']:.3e}) B={CLI_TEST_B} T={T} in {bpd_s:.2f} s with the restore "
        f"({bpd_s / T * 1e3:.2f} ms a step)")
    assert np.isfinite(result["test_total_bpd"]) and result["test_total_bpd"] > 0

    # 8f. Bits/dim at T = 50, kernels against the plain path, same noise.
    ds = SyntheticVisionDataset(image_size=CLI_IMG, channels=3, length=CLI_TEST_B, seed=SEED)
    batch = {"image": np.stack([ds[i]["image"] for i in range(CLI_TEST_B)])}
    x0 = preprocess_batch(batch, device)["pixel_values"]
    g = torch.Generator(device=device).manual_seed(SEED)
    noise = torch.randn((CLI_BPD_T, *x0.shape), generator=g, device=device)
    for dtype, must in (("bfloat16", unet), ("float32", ("group_norm_silu", "linear_attention_qkv"))):
        cfg = load_config(Path(__file__).resolve().parent / "examples/configs/ddpm/unet_small.yaml", overrides=[
            *CLI_MODEL, f"model.timesteps={CLI_BPD_T}", f"model.diffusion_model.dtype={dtype}"])
        bpd_model = port.DDPM(cfg.model, device=device, seed=SEED)
        run_bpd = lambda graphs=None: bpd_model.calculate_bits_per_dimension(  # noqa: E731
            x0, noise=noise, graphs=graphs)
        port.ops.reset_launch_counts()
        kern = run_bpd()
        torch.cuda.synchronize()
        cli_counts(port, f"bpd {dtype} T={CLI_BPD_T}", must)
        check_bpd_replays(dtype, run_bpd, kern)
        with plain_path(port):  # the plain versions run eagerly: a graph would replay the kernels
            plain = run_bpd(False)
        rel = float(((kern["total_bpd"] - plain["total_bpd"]).abs() / plain["total_bpd"].abs()).max())
        log(f"[cli] bpd {dtype} T={CLI_BPD_T} B={CLI_TEST_B}: total_bpd kernels {float(kern['total_bpd'].mean()):.5f} "
            f"plain {float(plain['total_bpd'].mean()):.5f}, max relative difference {rel:.3e} "
            f"(tol {BPD_REL_TOL[dtype]:.0e})")
        assert torch.isfinite(kern["terms_bpd"]).all() and rel <= BPD_REL_TOL[dtype], rel
        if dtype == "bfloat16":
            wall_ms = time_ms(run_bpd, iters=2)
            busy_ms = device_profile(run_bpd, iters=1)[0]
            log(f"[cli] bpd loop bf16 B={CLI_TEST_B}: {wall_ms / CLI_BPD_T:.3f} ms a step wall (CUDA events), "
                f"{busy_ms / CLI_BPD_T:.3f} ms device busy ({100 * busy_ms / wall_ms:.1f}%)")

    # 8g. serve from the archive path: one /sample of 4 PNGs.
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve_cli.build_server([f"model_path={dmn}", "port=0", f"ddim_timesteps={CLI_DDIM}"])
    build_s = time.perf_counter() - t0
    server.start_background()
    try:
        t1 = time.perf_counter()
        code, body = http("POST", f"http://{server.host}:{server.port}/sample", {"num_images": 4, "format": "png"})
        first_s = time.perf_counter() - t1
    finally:
        server.shutdown()
    cli_counts(port, "serve", unet)
    imgs = np.stack([decode_png(base64.b64decode(p)) for p in json.loads(body)["images"]])
    log(f"[cli] serve from {dmn.name}: restore + DDIM-{CLI_DDIM} warm-up batch (64) {build_s:.2f} s; first /sample (4 "
        f"images, png) {first_s:.3f} s, status {code}, decoded {list(imgs.shape)}")
    assert code == 200 and imgs.shape == (4, CLI_IMG, CLI_IMG, 3)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the README's path loaded {loaded}"
    log(f"[cli] none of {', '.join(NOT_ON_THE_CARD)} was imported")


# --------------------------------------------------------------- CUDA graphs --
GRAPH_DUMP_B = 4  # the save_every dump's batches (num_to_groups(4, 64) at 4 images)
GRAPH_BPD_B, GRAPH_BPD_T = 32, 1000
GRAPH_STALE_B, GRAPH_STALE_STEPS = 8, 10
GRAPH_SPE = 4
GRAPH_PROFILE_REPLAYS = 20


def walled(fn, n=1):
    """(seconds per call, the last result): the host clock around ``n``
    calls that ends in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, out


def graph_of(store, name):
    """The newest graph named ``name`` in an owner's ``graphs`` (a sampler's
    or a train state's)."""
    found = [g for g in store.values() if g.info["name"] == name]
    assert found, f"no {name!r} graph was captured"
    return found[-1]


def replay_profile(graph, counter, start, iters=GRAPH_PROFILE_REPLAYS):
    """Device busy per replay of a step graph in seconds, and ms per replay
    by kernel name (torch.profiler, over ``iters`` replays), its step
    counter set to ``start`` first so that every replay reads a valid t (an
    empty trace raises)."""
    import torch

    with torch.inference_mode():
        graph.static[counter].fill_(start)
        busy, by_name = device_profile(lambda: graph.replay(), iters=iters)
    return busy / 1e3, by_name


def replay_busy(graph, counter, start, iters=GRAPH_PROFILE_REPLAYS):
    """Device busy per replay of a step graph, in seconds."""
    return replay_profile(graph, counter, start, iters)[0]


def graph_line(tag, captured_s, busy_s, eager_s, graph, counts, replays, extra=None):
    """The [graph] line of one path; launches must equal the captured
    counts x replays (plus ``extra``, launches of steps run eagerly)."""
    expect = {k: v * replays + (extra or {}).get(k, 0) for k, v in graph.delta.items()}
    for k, v in (extra or {}).items():
        expect.setdefault(k, v)
    got = {k: v for k, v in counts.items() if v}
    info = graph.info
    busy = "not measured" if busy_s is None else f"{busy_s * 1e3:.3f} ms ({100 * busy_s / captured_s:.1f}% busy, " \
        f"captured / busy {captured_s / busy_s:.2f})"
    eager = "not measured" if eager_s is None else f"{eager_s * 1e3:.3f} ms ({eager_s / captured_s:.2f}x the captured)"
    log(f"[graph] {tag}: captured wall {captured_s * 1e3:.3f} ms, device busy {busy}, eager wall "
        f"{eager}; capture {info['capture_s']:.3f} s, "
        f"{info['nodes']} nodes, pool {info['pool_mib']:.1f} MiB; launches "
        f"{json.dumps(got)} = {json.dumps(graph.delta)} x {replays} replays"
        + (f" + eager {json.dumps(extra)}" if extra else ""))
    assert got == expect, (tag, got, expect)


def use_sampler(model, target, **extra):
    cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    model.change_sampler(dict(cfg, _target_=target, **extra))


DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
ANCESTRAL = "diffusion_model_nemo.modules.GaussianDiffusion"


def check_graph_ddim(port, tag, model, B, size, eager_runs=2):
    """DDIM-50 (the served chain, EMA weights) as replays of one step graph
    against the eager loop (timed over ``eager_runs``), bit for bit.
    Returns the captured chain's device split."""
    import torch

    use_sampler(model, DDIM, eta=0.0, ddim_timesteps=DDIM_STEPS)
    run = lambda graphs=None: model.sample(  # noqa: E731
        B, size, generator=torch.Generator(device=model.device).manual_seed(SEED), use_ema=True, graphs=graphs)
    eager_s, ref = walled(lambda: run(False), n=eager_runs)
    first_s, first = walled(run)  # the eager warm-up step and the capture
    port.ops.reset_launch_counts()
    wall, out = walled(run, n=3)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "ddim")
    busy, by_name = device_profile(run, iters=1)
    assert torch.equal(out, ref) and torch.equal(first, ref), f"{tag}: DDIM graph differs from eager"
    graph_line(f"{tag} DDIM-{DDIM_STEPS} B={B} (first call with capture {first_s:.3f} s; == eager bit for bit)",
               wall, busy / 1e3 if busy else None, eager_s, graph, counts, 3 * DDIM_STEPS)
    return by_name


def check_graph_ancestral(port, model, tag="ancestral dump chain", B=GRAPH_DUMP_B, seed=TRAIN_STEPS):
    """The save_every dump's chain (or ``tag``'s): 1000 steps of the model's
    ancestral sampler at batch 4 (the model's weights), replays of one step
    graph against the eager loop, bit for bit, and the generator's state
    after the chain."""
    import torch

    T = model.sampler.timesteps

    def run(graphs=None):
        g = torch.Generator(device=model.device).manual_seed(seed)
        return model.sample(B, 32, generator=g, graphs=graphs), g.get_state()

    eager_s, (ref, ref_state) = walled(lambda: run(False))
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, (out, state) = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "ancestral")
    busy = replay_busy(graph, "t", T - 1)
    same = torch.equal(out, ref) and torch.equal(state, ref_state)
    log(f"[graph] {tag} T={T} B={B}: == eager bit for bit, generator state equal after the chain: {same}; "
        f"finite {bool(torch.isfinite(out).all())}, std {float(out.std()):.4f} (first call with capture "
        f"{first_s:.3f} s)")
    assert same and bool(torch.isfinite(out).all()) and float(out.std()) > 0
    graph_line(f"{tag} T={T} B={B} (per step)", wall / T, busy, eager_s / T, graph, counts, T - 1,
               extra=dict(graph.delta))


def check_graph_bpd(port, model):
    """Bits/dim at T = 1000 on a batch of 32 (bf16): replays of one step
    graph against the eager loop, total_bpd bit for bit."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset, preprocess_batch

    use_sampler(model, ANCESTRAL)
    T = model.sampler.timesteps
    assert T == GRAPH_BPD_T, T
    ds = SyntheticVisionDataset(image_size=32, channels=3, length=GRAPH_BPD_B, seed=SEED)
    x0 = preprocess_batch({"image": np.stack([ds[i]["image"] for i in range(GRAPH_BPD_B)])},
                          model.device)["pixel_values"]
    run = lambda graphs=None: model.calculate_bits_per_dimension(x0, graphs=graphs)  # noqa: E731
    eager_s, ref = walled(lambda: run(False))
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, out = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "bpd")
    busy = replay_busy(graph, "t", T - 1)
    same = torch.equal(out["total_bpd"], ref["total_bpd"]) and torch.equal(out["terms_bpd"], ref["terms_bpd"])
    log(f"[graph] bpd bf16 T={T} B={GRAPH_BPD_B}: total_bpd {float(out['total_bpd'].mean()):.5f}, == eager bit "
        f"for bit: {same}; {wall:.3f} s a batch (eager {eager_s:.3f} s, first call with capture {first_s:.3f} s)")
    assert same
    graph_line(f"bpd bf16 T={T} B={GRAPH_BPD_B} (per step)", wall / T, busy, eager_s / T, graph, counts, T)


def fit_run(port, device, spe, graphs):
    """``Trainer.fit`` of unet_small at B=128, 20 steps, logging every 5:
    (model, trainer, seconds, launches, the run's train state)."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    cfg = unet_small_model_config()
    cfg["train_ds"]["name"] = "synthetic"
    model = port.DDPM(cfg, device=device, seed=SEED)
    trainer = port.Trainer(max_steps=TRAIN_STEPS, log_every_n_steps=5, devices=1, seed=SEED,
                           steps_per_execution=spe)
    states, init = [], trainer.init_state
    trainer.init_state = lambda m, n: states.append(init(m, n)) or states[-1]
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, graphs=graphs)
    torch.cuda.synchronize()
    return model, trainer, time.perf_counter() - t0, port.ops.launch_counts(), states[0]


def crossed_steps(max_steps, k, cadence):
    """The logged global_steps of the JAX trainer's rule: after each group
    of k steps (a tail of single steps), when step // cadence moved or at
    max_steps."""
    out, step = [], 0
    while step < max_steps:
        prev = step
        step = prev + k if prev + k <= max_steps else max_steps
        if (cadence > 0 and step // cadence > prev // cadence) or step == max_steps:
            out.append(step)
    return out


def tensors_of(model):
    return [*model.params.values(), *model.ema_params.values()]


def check_graph_training(port, device, per_step):
    """``Trainer.fit`` at B=128 for 20 steps: eager twice (is the eager step
    reproducible?), captured at steps_per_execution 1 and 4. The captured
    run equals the eager one bit for bit where eager repeats itself, else
    lies within the eager-to-eager difference; K = 4 equals K = 1 bit for
    bit and logs at the K boundaries."""
    import torch

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(tensors_of(a), tensors_of(b)))

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(tensors_of(a), tensors_of(b)))

    e1, _t, e1_s, _c, _st = fit_run(port, device, 1, False)
    e2, _t, _s, _c, _st = fit_run(port, device, 1, False)
    g1, t1, g1_s, c1, _st = fit_run(port, device, 1, None)
    g4, t4, g4_s, c4, s4 = fit_run(port, device, GRAPH_SPE, None)
    ee, ee_diff = equal(e1, e2), max_diff(e1, e2)
    ge, ge_diff = equal(g1, e1), max_diff(g1, e1)
    log(f"[graph] fit B={TRAIN_B} {TRAIN_STEPS} steps: eager twice bit-equal {ee} (max |diff| {ee_diff:.3e}); "
        f"captured (K=1) vs eager: bit-equal {ge} (max |diff| {ge_diff:.3e}); K={GRAPH_SPE} vs K=1 bit-equal "
        f"{equal(g4, g1)}; fit seconds with set-up: eager {e1_s:.2f}, captured K=1 {g1_s:.2f}, "
        f"K={GRAPH_SPE} {g4_s:.2f}")
    assert ge if ee else ge_diff <= ee_diff, "the captured training run left the eager one's bounds"
    assert equal(g4, g1), f"steps_per_execution={GRAPH_SPE} differs from 1"
    for trainer, k in ((t1, 1), (t4, GRAPH_SPE)):
        logged = [m["global_step"] for m in trainer.logged]
        expect = crossed_steps(TRAIN_STEPS, k, 5)
        log(f"[graph] fit K={k}: logged global_steps {logged} (the JAX rule: {expect})")
        assert logged == expect, (k, logged, expect)
    graph = graph_of(s4.graphs, "train_step")
    for tag, counts in (("K=1", c1), (f"K={GRAPH_SPE}", c4)):
        assert_counts(f"fit {TRAIN_STEPS} steps captured {tag}", counts,
                      {k: v * TRAIN_STEPS for k, v in per_step.items()})
    log(f"[graph] train_step B={TRAIN_B}: pool {graph.info['pool_mib']:.1f} MiB, {graph.info['nodes']} nodes, "
        f"capture {graph.info['capture_s']:.3f} s; launches = the first (eager) step + {graph.delta} x "
        f"{TRAIN_STEPS - 1} replays")


def check_graph_stale(port, device):
    """A replay after an in-place parameter update (an AdamW step on the
    model's weights) and after an EMA swap equals the eager path: the graph
    is keyed on the parameters' versions and identity and captured anew.
    The graph captured before the update, replayed by hand after it, reads
    the old derived weights and differs: the gate would catch that."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
    from diffusion_model_nemo_tpu_torch.training import build_optimizer, ema_decay_table, ema_update

    model = port.DDPM(unet_small_model_config(), device=device, seed=SEED)
    use_sampler(model, DDIM, eta=0.0, ddim_timesteps=GRAPH_STALE_STEPS)
    shape = (GRAPH_STALE_B, 32, 32, 3)
    gen = lambda: torch.Generator(device=device).manual_seed(SEED)  # noqa: E731
    run = lambda ema=False, graphs=None: model.sample(  # noqa: E731
        GRAPH_STALE_B, 32, generator=gen(), use_ema=ema, graphs=graphs)
    before = run()
    old = graph_of(model.sampler.graphs, "ddim")
    opt, _ = build_optimizer(model.cfg.optim, 10)
    state = opt.init(model.params)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    grads = {k: torch.randn(v.shape, generator=g, device=device) for k, v in model.params.items()}
    with torch.no_grad():
        opt.step(model.params, grads, state, scalars=opt.table(0, device)[0])
    after, eager = run(), run(graphs=False)
    new = graph_of(model.sampler.graphs, "ddim")
    recaptured = int(new is not old and len(model.sampler.graphs) == 1)
    static = old.static
    with torch.inference_mode():
        static["x"].copy_(torch.randn(shape, generator=gen(), device=device))
        static["i"].zero_()
        old.replay(GRAPH_STALE_STEPS)
        stale = (static["x"] + 1.0) * 0.5
    with torch.no_grad():
        ema_update(model.ema_params, model.params, ema_decay_table(0.5, 0, device)[0])
    ema_g, ema_e = run(ema=True), run(ema=True, graphs=False)
    log(f"[graph] after an in-place AdamW step: replay == eager {torch.equal(after, eager)} ({recaptured} new "
        f"capture), output moved {not torch.equal(after, before)}; the old graph replayed by hand == eager "
        f"{torch.equal(stale, eager)} (max |diff| {float((stale - eager).abs().max()):.3e}: stale derived "
        f"weights); after an EMA update and swap: replay == eager {torch.equal(ema_g, ema_e)}")
    assert torch.equal(after, eager) and recaptured == 1 and not torch.equal(after, before)
    assert not torch.equal(stale, eager), "a stale replay would pass this gate"
    assert torch.equal(ema_g, ema_e)


def python_float_update(opt, p, grads, mu, nu, count):
    """One AdamW update with Python-float scalars at ``count`` (-lr and the
    bias corrections as the port computed them before its tables), after
    the port's clip: the reference of ``check_graph_scalars``."""
    import torch

    from diffusion_model_nemo_tpu_torch.training import clip_by_global_norm

    keys = list(p)
    grads = clip_by_global_norm(grads, float(opt.grad_clip))
    g, ps, ms, vs = ([d[k] for k in keys] for d in (grads, p, mu, nu))
    torch._foreach_mul_(ms, opt.b1)
    torch._foreach_add_(ms, torch._foreach_mul(g, 1.0 - opt.b1))
    torch._foreach_mul_(vs, opt.b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - opt.b2))
    m_hat = torch._foreach_div(ms, 1.0 - opt.b1 ** (count + 1))
    v_hat = torch._foreach_div(vs, 1.0 - opt.b2 ** (count + 1))
    upd = torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), opt.eps))
    if opt.weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(ps, opt.weight_decay))
    torch._foreach_add_(ps, torch._foreach_mul(upd, -opt.schedule(count)))


def check_graph_scalars(port, device):
    """The optimizer's and the EMA's per-step scalars read from rows of
    device tables give the bits of Python-float scalars on CUDA (where
    ATen divides by a Python float through its reciprocal), 6 steps, with
    and without warm-up and cosine decay."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
    from diffusion_model_nemo_tpu_torch.training import build_optimizer, ema_decay_at, ema_decay_table, ema_update

    g = torch.Generator(device=device).manual_seed(SEED)
    shapes = {"a": (64, 32), "b": (32,), "c": (3, 3, 16, 16)}
    start = {k: torch.randn(s, generator=g, device=device) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g, device=device) * (0.4 if i % 2 else 0.05) for k, s in shapes.items()}
             for i in range(6)]
    configs = {"unet_small": unet_small_model_config()["optim"],
               "warmup_cosine": dict(name="adamw", lr=2e-3, weight_decay=0.01,
                                     sched=dict(name="CosineAnnealing", warmup_steps=2, min_lr=1e-5)),
               "constant": dict(name="adam", lr=3e-4, sched=None)}
    results = {}
    for name, cfg in configs.items():
        opt, _ = build_optimizer(cfg, 6, grad_clip=1.0)
        table, ema_table = opt.table(5, device), ema_decay_table(0.9999, 5, device)
        out = []
        for tabled in (False, True):
            p = {k: v.clone() for k, v in start.items()}
            st = opt.init(p)
            ema = {k: v.clone() for k, v in start.items()}
            for i in range(6):
                if tabled:
                    opt.step(p, grads[i], st, scalars=table[i])
                    ema_update(ema, p, ema_table[i])
                else:
                    python_float_update(opt, p, grads[i], st["mu"], st["nu"], i)
                    d = ema_decay_at(0.9999, i)
                    torch._foreach_mul_(list(ema.values()), d)
                    torch._foreach_add_(list(ema.values()), torch._foreach_mul(
                        list(p.values()), float(np.float32(1.0) - np.float32(d))))
            out.append([*p.values(), *st["mu"].values(), *st["nu"].values(), *ema.values()])
        results[name] = all(torch.equal(a, b) for a, b in zip(*out))
    log(f"[graph] optimizer and EMA scalars from device tables vs Python floats on CUDA, 6 steps "
        f"(params, moments, EMA bit for bit): {json.dumps(results)}")
    assert all(results.values()), results


def log_device_split(by_name, steps, tag=f"unet_small DDIM step B={B}", prefix="[graph]"):
    """A captured step's device time per step, by kernel name."""
    total = sum(by_name.values())
    hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
    log(f"{prefix} captured {tag} device split: {total / steps:.3f} ms a step, hand kernels "
        f"{hand / steps:.3f} ms, other {(total - hand) / steps:.3f} ms in {len(by_name)} kernel names")
    for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"{prefix}   {v / steps:.4f} ms  {n[:110]}")


def check_graphs(port, models, device, per_step):
    """9. The loops as CUDA graph replays against their eager Python loops."""
    t9 = time.perf_counter()
    check_graph_scalars(port, device)
    split = check_graph_ddim(port, "unet_small", models["unet_small"], B, 32)
    log_device_split(split, DDIM_STEPS)
    check_graph_ddim(port, "dit_s2", models["dit_s2"], DIT_MAX_BATCH, DIT_IMG)
    use_sampler(models["unet_small"], ANCESTRAL)
    check_graph_ancestral(port, models["unet_small"])
    check_graph_bpd(port, models["unet_small"])
    check_graph_training(port, device, per_step)
    check_graph_stale(port, device)
    log(f"[graph] phase 9 in {time.perf_counter() - t9:.1f} s")


# ------------------------------------------------------------ the two families --
FAMILY_CONFIGS = {"improved": "examples/configs/improved_ddpm/unet_small.yaml",
                  "conditional": "examples/configs/conditional_ddpm/unet_small.yaml"}
NUM_CLASSES = 10
FAMILY_METRIC_TOL = 2e-2  # the four metrics, kernels vs plain path, relative, bf16
FAMILY_GRAD_TOL = 2e-2  # the whole gradient, relative L2, bf16
FAMILY_ANCESTRAL_B = 16
FAMILY_BPD_B = 32
COND_LABEL, COND_SCALE, COND_SEED = 3, 3.0, 77


def family_model(port, device, family, overrides=()):
    """ImprovedDDPM or ConditionalDDPM (K = 10) from its shipped YAML at 32
    px, full width, random weights from ``SEED``."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    extra = [f"model.num_classes={NUM_CLASSES}"] if family == "conditional" else []
    cfg = load_config(Path(__file__).resolve().parent / FAMILY_CONFIGS[family], overrides=[
        *CLI_MODEL, "model.train_ds.name=synthetic", *extra, *overrides]).model
    cls = port.models.ImprovedDDPM if family == "improved" else port.models.ConditionalDDPM
    return cls(cfg, device=device, seed=SEED)


def check_family_step(port, tag, model, per_forward):
    """One B=128 training step with the kernels against the plain path from
    the same weights, batch and draws (a conditional model's label mask
    among them): every metric and the whole gradient; the backward launches
    nothing."""
    batch, draws = training_batch(model, TRAIN_B)
    loss_k, g_k, fwd, bwd, m_k = step_loss_and_grads(port, model, batch, draws)
    assert_counts(f"{tag} step forward", fwd, per_forward)
    assert_counts(f"{tag} step backward", bwd, {})
    with plain_path(port):
        _l, g_p, _f, _b, m_p = step_loss_and_grads(port, model, batch, draws)
    rel = {k: abs(m_k[k] - m_p[k]) / abs(m_p[k]) for k in m_p}
    rel_grad = float((g_k - g_p).norm() / g_p.norm())
    log(f"[family] {tag} step B={TRAIN_B} kernels vs plain: "
        + ", ".join(f"{k} {m_k[k]:.6f} / {m_p[k]:.6f} (rel {rel[k]:.3e})" for k in m_p)
        + f"; whole gradient ({g_k.numel()} values) rel_l2 {rel_grad:.3e} (tol {FAMILY_METRIC_TOL}, "
        f"{FAMILY_GRAD_TOL})")
    assert set(m_k) == set(m_p) and all(v <= FAMILY_METRIC_TOL for v in rel.values()), rel
    assert rel_grad <= FAMILY_GRAD_TOL and all(map(lambda v: abs(v) < 1e6, m_k.values()))
    return m_k


def family_step_timing(port, tag, model):
    """The captured B=128 step: wall (CUDA events over 20 replays), device
    busy (torch.profiler) and the graph's pool."""
    batch, draws = training_batch(model, TRAIN_B)
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
    state = trainer.init_state(model, TRAIN_STEPS)
    run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
    wall = time_ms(run, iters=20)
    busy, _ = device_profile(run, iters=5)
    info = graph_of(state.graphs, "train_step").info
    log(f"[family] {tag} captured step B={TRAIN_B}: wall {wall:.3f} ms (CUDA events), {TRAIN_B / wall * 1e3:.1f} "
        f"samples/s; device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); graph pool {info['pool_mib']:.1f} MiB, "
        f"{info['nodes']} nodes, capture {info['capture_s']:.3f} s")


def check_family_ancestral(port, model):
    """The 1000-step ancestral chain with the learned variance at B=16:
    graph replays against the eager loop, bit for bit, both under
    ``cudnn.deterministic``."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        check_graph_ancestral(port, model, "improved ancestral chain (learned variance, cudnn.deterministic)",
                              FAMILY_ANCESTRAL_B, SEED)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def family_bpd_batch(device, B):
    import numpy as np

    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset, preprocess_batch

    ds = SyntheticVisionDataset(image_size=32, channels=3, length=B, seed=SEED)
    return preprocess_batch({"image": np.stack([ds[i]["image"] for i in range(B)])}, device)["pixel_values"]


def check_family_bpd(port, model, device, per_forward):
    """ImprovedDDPM bits/dim (the learned variance through the sampler): at
    T = 1000 on a batch of 32, captured (s a batch, device busy), then at T
    = 50 with the same noise on the kernel path and the plain path."""
    import torch

    x0 = family_bpd_batch(device, FAMILY_BPD_B)
    T = model.sampler.timesteps
    run = lambda: model.calculate_bits_per_dimension(x0)  # noqa: E731
    walled(run)  # the eager first step and the capture
    port.ops.reset_launch_counts()
    wall, out = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "bpd")
    busy = replay_busy(graph, "t", T - 1)
    log(f"[family] improved bits/dim T={T} B={FAMILY_BPD_B}: total_bpd {float(out['total_bpd'].mean()):.5f}, "
        f"{wall:.3f} s a batch")
    graph_line(f"improved bpd T={T} B={FAMILY_BPD_B} (per step)", wall / T, busy, None, graph, counts, T)
    assert torch.isfinite(out["terms_bpd"]).all()
    short = family_model(port, device, "improved", [f"model.timesteps={CLI_BPD_T}"])
    noise = torch.randn((CLI_BPD_T, *x0.shape), generator=torch.Generator(device=device).manual_seed(SEED),
                        device=device)
    port.ops.reset_launch_counts()
    kern = short.calculate_bits_per_dimension(x0, noise=noise)
    torch.cuda.synchronize()
    assert_counts(f"improved bpd T={CLI_BPD_T}", port.ops.launch_counts(),
                  {k: v * CLI_BPD_T for k, v in per_forward.items()})
    with plain_path(port):
        plain = short.calculate_bits_per_dimension(x0, noise=noise, graphs=False)
    rel = float(((kern["total_bpd"] - plain["total_bpd"]).abs() / plain["total_bpd"].abs()).max())
    log(f"[family] improved bits/dim T={CLI_BPD_T} B={FAMILY_BPD_B}: total_bpd kernels "
        f"{float(kern['total_bpd'].mean()):.5f} plain {float(plain['total_bpd'].mean()):.5f}, max relative "
        f"difference {rel:.3e} (tol {BPD_REL_TOL['bfloat16']:.0e})")
    assert rel <= BPD_REL_TOL["bfloat16"], rel


def check_improved(port, device):
    """10a. ImprovedDDPM at examples/configs/improved_ddpm/unet_small.yaml's
    full width."""
    model = family_model(port, device, "improved")
    per = derived_counts(port, model, TRAIN_B, 32)
    log(f"[family] improved: {type(model.sampler).__name__}, output channels "
        f"{model.diffusion_model.final_conv.weight.shape[0]}, launches a forward (gates) {json.dumps(per)}")
    check_family_step(port, "improved", model, per)
    family_step_timing(port, "improved", model)
    fit_model = family_model(port, device, "improved")
    _m, trainer, _c = check_fit(port, device, TRAIN_STEPS, {}, per, model=fit_model)
    assert all(k in trainer.logged[-1] for k in ("simple_loss", "vb_losses", "decoder_nll")), trainer.logged[-1]
    check_family_ancestral(port, model)
    check_family_bpd(port, model, device, per)


def check_conditional_serving(port, model, per_forward):
    """10b. ``SamplingServer`` on the ConditionalDDPM, DDIM-50, max_batch 64:
    /sample with a label, without one, guided (seeded, == the eager guided
    chain bit for bit) and with a bad label (400); every kernel's launches
    equal one forward's x 50 x batches (a guided batch is one 2B forward a
    step)."""
    import urllib.error

    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        results, bad = {}, None

        def request(key, payload):
            results[key] = http("POST", base + "/sample", payload)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=request, args=(key, dict(payload, format="npy"))) for key, payload in (
            ("label", {"num_images": 5, "label": COND_LABEL}), ("null", {"num_images": 3}))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            assert not th.is_alive(), "a concurrent request did not finish"
        request("guided", {"num_images": 3, "label": COND_LABEL, "guidance_scale": COND_SCALE, "seed": COND_SEED,
                           "format": "npy"})
        wall = time.perf_counter() - t1
        try:
            http("POST", base + "/sample", {"num_images": 1, "label": NUM_CLASSES})
        except urllib.error.HTTPError as e:
            bad = e.code
        stats = json.loads(http("GET", base + "/stats")[1])
    finally:
        server.shutdown()
    assert all(r[0] == 200 for r in results.values()) and bad == 400, ({k: r[0] for k, r in results.items()}, bad)
    arrays = {k: np.load(io.BytesIO(r[1])) for k, r in results.items()}
    for k, n in (("label", 5), ("null", 3), ("guided", 3)):
        assert arrays[k].shape == (n, 32, 32, 3) and arrays[k].dtype == np.uint8 and arrays[k].std() > 0, k
    counts = port.ops.launch_counts()
    g = torch.Generator(device=model.device).manual_seed(COND_SEED)
    eager = model.sample(B, 32, generator=g, label=COND_LABEL, guidance_scale=COND_SCALE, use_ema=True, graphs=False)
    eager = to_uint8_tensor(eager)[:3].cpu().numpy()
    assert np.array_equal(arrays["guided"], eager), "the served guided request differs from the eager chain"
    batches = stats["batches"] + 1  # + the warm-up batch
    log(f"[family] conditional serve DDIM-{DDIM_STEPS} max_batch={B}: warm-up {warm_s:.2f} s; label {COND_LABEL}, "
        f"null and guided (w={COND_SCALE}, seeded) requests in {wall:.3f} s, a bad label answered {bad}; the "
        f"guided seeded request == the eager guided chain bit for bit; stats {json.dumps(stats)}")
    assert stats["batches"] == 3, stats
    for name, n in counts.items():
        expect = per_forward.get(name, 0) * DDIM_STEPS * batches
        log(f"[family] conditional serve launches {name}: {n} (expected {per_forward.get(name, 0)}/forward x "
            f"{DDIM_STEPS} x {batches})")
        assert n == expect, (name, n, expect)
    assert all(counts[name] > 0 for name in per_forward), counts


def conditional_ddim_timing(model):
    """Conditional DDIM-50 at B=64 captured, with and without guidance:
    images/s, device busy, the graphs' pools."""
    import torch

    for w in (None, COND_SCALE):
        run = lambda: model.sample(  # noqa: E731
            B, 32, generator=torch.Generator(device=model.device).manual_seed(SEED), label=COND_LABEL,
            guidance_scale=w, use_ema=True)
        walled(run)  # captured already by the server, unless the graph keys differ
        wall, out = walled(run, n=2)
        busy, _ = device_profile(run, iters=1)
        graphs = [g for g in model.sampler.graphs.values() if g.info["name"] == "ddim"]
        log(f"[family] conditional DDIM-{DDIM_STEPS} B={B} label {COND_LABEL} guidance {w}: {wall * 1e3:.3f} ms a "
            f"chain, {B / wall:.2f} images/s, device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%); ddim "
            f"graphs' pools {[round(g.info['pool_mib'], 1) for g in graphs]} MiB")
        assert bool(torch.isfinite(out).all())


def check_conditional(port, device):
    """10b. ConditionalDDPM (K = 10) at examples/configs/conditional_ddpm/
    unet_small.yaml's full width."""
    model = family_model(port, device, "conditional")
    per = derived_counts(port, model, TRAIN_B, 32)
    per_2b = derived_counts(port, model, 2 * B, 32)
    per_b = derived_counts(port, model, B, 32)
    log(f"[family] conditional: launches a forward (gates) at B={B} {json.dumps(per_b)}, at the guided 2B "
        f"{json.dumps(per_2b)}")
    assert per_b == per_2b == per, (per_b, per_2b, per)
    check_family_step(port, "conditional", model, per)
    check_conditional_serving(port, model, per_b)
    conditional_ddim_timing(model)


def check_dit_classes(port, device):
    """10c. DiT-S/2 with ``num_classes=10`` (a learned null row added to c)
    at 64 px: one forward with #7 against the plain path, labels and null
    rows mixed."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import dit_small_model_config

    cfg = dit_small_model_config()
    cfg["diffusion_model"]["num_classes"] = NUM_CLASSES
    model = port.DDPM(cfg, device=device, seed=SEED)
    redraw_zero_leaves(model)
    x, t = model_inputs(device, DIT_IMG, DIT_MAX_BATCH)
    classes = torch.arange(DIT_MAX_BATCH, device=device, dtype=torch.int32) % (NUM_CLASSES + 1)
    port.ops.reset_launch_counts()
    out_k = model.forward(x, t, classes)
    torch.cuda.synchronize()
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    with plain_path(port):
        out_p = model.forward(x, t, classes)
    null = model.forward(x, t)
    rel = float((out_k - out_p).norm() / out_p.norm())
    moved = float((out_k - null).abs().max())
    log(f"[family] dit_s2 num_classes={NUM_CLASSES} B={DIT_MAX_BATCH}: kernels vs plain rel_l2 {rel:.3e} (tol "
        f"{UNET_REL_TOL}); launches {json.dumps(counts)}; labels move the output by max |d| {moved:.3e}")
    assert counts == {"attention": 12} and rel <= UNET_REL_TOL and moved > 0 and bool(torch.isfinite(out_k).all())


def check_family_clis(port, device, tmp):
    """10d. The six CLIs' path at full width: train_improved_ddpm (10 steps,
    a .dmn) → test_improved_ddpm (bits/dim of 32 images at T = 1000);
    train_conditional_ddpm (10 steps) → eval_conditional_ddpm (label, guided)
    → serve from the archive."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import (
        eval_conditional_ddpm, serve as serve_cli, test_improved_ddpm, train_conditional_ddpm, train_improved_ddpm,
    )
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    unet = ("group_norm_silu", "linear_attention_block", "linear_attention_tokens", "attention_block_small")
    base = [*CLI_MODEL, "model.train_ds.name=synthetic", "trainer.max_steps=10", f"exp_manager.exp_dir={tmp}/exp",
            "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run"]
    dmn = {}
    for name, cli, extra in (("improved", train_improved_ddpm, []),
                             ("conditional", train_conditional_ddpm, [f"model.num_classes={NUM_CLASSES}"])):
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, trainer = cli.main([*base, *extra])
        cli_counts(port, f"train_{name}_ddpm", unet)
        dmn[name] = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
        log(f"[family] train_{name}_ddpm 10 steps B={TRAIN_B}: {time.perf_counter() - t0:.2f} s, logged "
            f"{json.dumps(trainer.logged)}, archive {dmn[name].name}")
        assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = test_improved_ddpm.main([f"model_path={dmn['improved']}", "limit_test_batches=1",
                                      f"batch_size={CLI_TEST_B}"])
    bpd_s = time.perf_counter() - t0
    cli_counts(port, "test_improved_ddpm", unet)
    log(f"[family] test_improved_ddpm: test_total_bpd {result['test_total_bpd']:.5f} B={CLI_TEST_B} T=1000 in "
        f"{bpd_s:.2f} s with the restore")
    assert np.isfinite(result["test_total_bpd"]) and result["test_total_bpd"] > 0
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eval_conditional_ddpm.main([f"model_path={dmn['conditional']}", f"batch_size={B}", f"label={COND_LABEL}",
                                      f"guidance_scale={COND_SCALE}", f"ddim_timesteps={DDIM_STEPS}",
                                      f"output_dir={tmp}/samples", "add_timestamp=false"])
    eval_s = time.perf_counter() - t0
    cli_counts(port, "eval_conditional_ddpm", unet)
    grid = decode_png((out / f"samples_class{COND_LABEL}.png").read_bytes())
    log(f"[family] eval_conditional_ddpm label {COND_LABEL} w={COND_SCALE} DDIM-{DDIM_STEPS} B={B}: {eval_s:.2f} s "
        f"with the restore, grid {list(grid.shape)}")
    assert grid.std() > 0
    port.ops.reset_launch_counts()
    server = serve_cli.build_server([f"model_path={dmn['conditional']}", "port=0", f"ddim_timesteps={DDIM_STEPS}"])
    server.start_background()
    try:
        code, body = http("POST", f"http://{server.host}:{server.port}/sample",
                          {"num_images": 4, "label": COND_LABEL, "format": "png"})
    finally:
        server.shutdown()
    cli_counts(port, "serve (conditional archive)", unet)
    imgs = np.stack([decode_png(base64.b64decode(p)) for p in json.loads(body)["images"]])
    log(f"[family] serve from {dmn['conditional'].name}: /sample label {COND_LABEL} status {code}, "
        f"{list(imgs.shape)}")
    assert code == 200 and imgs.shape == (4, CLI_IMG, CLI_IMG, 3)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the families' CLIs loaded {loaded}"
    log(f"[family] none of {', '.join(NOT_ON_THE_CARD)} was imported")


def check_families(port, device):
    """10. ImprovedDDPM and ConditionalDDPM end to end, the DiT with
    classes, the six CLIs."""
    t10 = time.perf_counter()
    check_improved(port, device)
    check_conditional(port, device)
    check_dit_classes(port, device)
    tmp = tempfile.mkdtemp(prefix="dmn_family_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        check_family_clis(port, device, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[family] phase 10 in {time.perf_counter() - t10:.1f} s")


# ------------------------------------------------------------- the score SDE --
SDE_CONFIG = "examples/configs/score_sde/vp/unet_small.yaml"
SDE_B, SDE_LIK_B = 64, 32
SDE_PREFIX = 20  # steps of each other predictor x corrector's captured chain held to eager
SDE_OTHER_PREFIX = 50  # sub-VP and VE: the captured PC prefix held to eager
SDE_FWD_TOL = 3e-2  # bf16 forward at float labels, relative L2 against the plain path
SDE_BPD_TOL = 2e-2  # likelihood bits/dim, kernels vs plain path, relative
SDE_LIK_PROFILE_REPLAYS = 3  # the likelihood's RK step replays traced for its busy share
SDE_CLI_STEPS = 3
SDE_CLI_TEST_B = 8  # test_score_sde's batch: its solve at rtol 1e-5 takes ~1600 evaluations
SDE_SERVE_SEED = 4321
PF = "diffusion_model_nemo.modules.ProbabilityFlowSampler"
UNET_KERNELS = ("group_norm_silu", "linear_attention_block", "linear_attention_tokens", "attention_block_small")


def sde_model(port, device, overrides=()):
    """ScoreSDE at examples/configs/score_sde/vp/unet_small.yaml's full width
    (32 px, dim 32, dim_mults [1,2,4,8], 4 GroupNorm groups, bf16, N =
    1000), random weights from ``SEED`` with the all-zero leaves redrawn."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / SDE_CONFIG, overrides=[
        *CLI_MODEL, "model.train_ds.name=synthetic", *overrides]).model
    model = port.models.ScoreSDE(cfg, device=device, seed=SEED)
    redraw_zero_leaves(model)
    return model


def sde_labels(model, t):
    """The network's time labels of the model's SDE at t: t·(N−1), or σ(t) (VE)."""
    import torch

    if type(model.sde).__name__ == "VESDE":
        return model.sde.marginal_prob(torch.zeros(()), t)[1]
    return t * (model.sde.N - 1)


def pc_chain(model, B, steps, graphs, seed=SEED):
    """The model's PC chain for its first ``steps`` steps (EMA weights) on a
    fresh generator: (images, generator state)."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.inference_mode():
        out = model.sampler.sample(model.get_model_fn(), model.ema_params, (B, 32, 32, 3), g, graphs=graphs,
                                   num_steps=steps)
    return out, g.get_state()


def check_pc_prefix(port, tag, model, steps, B=SDE_B):
    """The captured chain's first ``steps`` steps against the eager loop,
    bit for bit (generator state too), under ``cudnn.deterministic``."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager_s, (ref, ref_state) = walled(lambda: pc_chain(model, B, steps, False))
        first_s, (first, _) = walled(lambda: pc_chain(model, B, steps, None))
        wall, (out, state) = walled(lambda: pc_chain(model, B, steps, None))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(out, ref) and torch.equal(first, ref) and torch.equal(state, ref_state)
    log(f"[sde] {tag} PC prefix {steps} steps B={B} ({model.sampler.predictor} x {model.sampler.corrector}, "
        f"n_steps {model.sampler.n_steps}): captured == eager bit for bit: {same}; captured {wall:.3f} s, "
        f"eager {eager_s:.3f} s, first call with capture {first_s:.3f} s; finite "
        f"{bool(torch.isfinite(out).all())}")
    assert same and bool(torch.isfinite(out).all())


def sde_inputs(model, device):
    """x [64, 32, 32, 3] and the SDE's float time labels at seeded t in [0, 1)."""
    import torch

    x, _ = model_inputs(device, 32)
    t = torch.rand(SDE_B, generator=torch.Generator(device=device).manual_seed(SEED), device=device)
    return x, sde_labels(model, t)


def check_sde_forward(port, model, device, rows):
    """11.1-11.2: the ScoreSDE U-Net's kernel calls at B=64 and float time
    labels, each held against its plain version (#1-#4; 4 GroupNorm groups
    at every site); one bf16 forward at float labels t·999 against the
    plain path. Returns the launches per forward."""
    calls = record_calls(port, model, *sde_inputs(model, device))
    per = per_forward_counts(calls)
    groups = sorted({args[3] for _c, args in calls["group_norm_silu"].values()})
    log(f"[sde] ScoreSDE U-Net B={SDE_B}: launches a forward {json.dumps(per)}; GroupNorm groups at every "
        f"site {groups}; {sum(len(v) for v in calls.values())} kernel shapes")
    assert set(per) == set(UNET_KERNELS) and groups == [4], (per, groups)
    for name, r in check_kernels(port, {"score_sde": calls}).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], r["max_abs_err"])
    check_forward(port, "score_sde (float labels t*999)", model, *sde_inputs(model, device), SDE_FWD_TOL)
    return per


def check_sde_em_chain(port, model, per):
    """11.3: the config's PC sampler (Euler-Maruyama, no corrector), N =
    1000, B = 64: a captured prefix == eager; the whole chain captured:
    wall, device busy, images/s, pool, launches = per forward x steps."""
    import torch

    check_pc_prefix(port, "euler_maruyama", model, SDE_PREFIX)
    N = model.sde.N
    run = lambda: pc_chain(model, SDE_B, None, None)  # noqa: E731
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, (out, _) = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "pc")
    busy = replay_busy(graph, "i", 0)
    log(f"[sde] PC euler_maruyama N={N} B={SDE_B}: {wall:.3f} s a chain, {SDE_B / wall:.2f} images/s (first call "
        f"with capture {first_s:.3f} s); finite {bool(torch.isfinite(out).all())}, std {float(out.std()):.4f}")
    graph_line(f"score_sde PC euler_maruyama N={N} B={SDE_B} (per step)", wall / N, busy, None, graph, counts, N)
    assert counts == {k: per.get(k, 0) * N for k in counts}, (counts, per)


def check_sde_combinations(port, model):
    """11.4: reverse_diffusion and ancestral_sampling x langevin and ald at
    n_steps 1, each a captured prefix == eager."""
    base = dict(model.cfg.sampler)
    try:
        for predictor in ("reverse_diffusion", "ancestral_sampling"):
            for corrector in ("langevin", "ald"):
                model.change_sampler(dict(base, predictor=predictor, corrector=corrector, n_steps=1))
                check_pc_prefix(port, f"{predictor} x {corrector}", model, SDE_PREFIX)
    finally:
        model.change_sampler(base)


def check_sde_serving(port, model, per, tmp):
    """11.5: the model saved to a .dmn, restored through
    ``restore_model_from_archive`` and served with its own PC sampler
    (max_batch 64): /sample requests answered, launches = per forward x N x
    batches; ``use_ddim_sampler=True`` refused."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    path = model.save_to(str(Path(tmp) / "ScoreSDE.dmn"))
    restored = port.models.restore_model_from_archive(path, device=model.device)
    assert type(restored).__name__ == "ScoreSDE"
    try:
        serve(restored, port=0, max_batch=SDE_B)
        raise AssertionError("serving a ScoreSDE with use_ddim_sampler=True was not refused")
    except ValueError as e:
        refusal = str(e)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(restored, port=0, max_batch=SDE_B, use_ddim_sampler=False, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        t1 = time.perf_counter()
        code_png, body_png = http("POST", base + "/sample", {"num_images": 4, "format": "png"})
        code_npy, body_npy = http("POST", base + "/sample", {"num_images": 8, "seed": SDE_SERVE_SEED,
                                                            "format": "npy"})
        wall = time.perf_counter() - t1
        stats = json.loads(http("GET", base + "/stats")[1])
    finally:
        server.shutdown()
    imgs = [decode_png(base64.b64decode(p)) for p in json.loads(body_png)["images"]]
    npy = np.load(io.BytesIO(body_npy))
    assert code_png == code_npy == 200 and len(imgs) == 4 and imgs[0].shape == (32, 32, 3)
    assert npy.shape == (8, 32, 32, 3) and npy.dtype == np.uint8 and npy.std() > 0
    counts = port.ops.launch_counts()
    batches, N = stats["batches"] + 1, restored.sde.N  # + the warm-up batch
    log(f"[sde] serve ScoreSDE archive PC N={N} max_batch={SDE_B}: warm-up {warm_s:.2f} s; 2 requests in "
        f"{wall:.3f} s, mean latency {stats['avg_request_latency_ms']:.1f} ms, "
        f"{SDE_B * stats['batches'] / wall:.2f} images/s computed; stats {json.dumps(stats)}; "
        f"use_ddim_sampler=True refused: {refusal!r}")
    assert counts == {k: per.get(k, 0) * N * batches for k in counts}, (counts, per, batches)


def check_sde_training(port, model):
    """11.6: one B=128 training step with the kernels against the plain
    path (loss 1e-2 relative, whole gradient 2e-2 relative L2, nothing
    launched in the backward); the captured step's time."""
    per = derived_counts(port, model, TRAIN_B, 32)
    batch, draws = training_batch(model, TRAIN_B)
    assert draws["t"].dtype.is_floating_point
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts("score_sde step forward", fwd, per)
    assert_counts("score_sde step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _f, _b, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_grad = float((g_k - g_p).norm() / g_p.norm())
    log(f"[sde] score_sde step B={TRAIN_B} kernels vs plain: loss {loss_k:.6f} / {loss_p:.6f} (rel "
        f"{rel_loss:.3e}, tol {LOSS_REL_TOL}); whole gradient rel_l2 {rel_grad:.3e} (tol {FAMILY_GRAD_TOL})")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= FAMILY_GRAD_TOL
    family_step_timing(port, "score_sde", model)


def solve_replays(graph, run):
    """(wall s, result, replays) of one more captured solve, ``run``,
    timed end to end on the host clock: ``replays`` counts the RK step's
    replays in it, the active steps and those after ``done``."""
    before = graph.info["replays"]
    wall, out = walled(run)
    return wall, out, graph.info["replays"] - before


def after_done_line(port, replays, nfe, wall):
    """How many of a solve's replays came after ``done`` and their share of
    its wall (each replay costs the same, active or not)."""
    steps = nfe // 7
    assert steps <= replays < steps + port.ops.ode.CHECK_EVERY, (steps, replays)
    return (f"{replays} replays: {steps} RK steps and {replays - steps} after done, "
            f"~{(replays - steps) * wall / replays:.3f} s, {100 * (replays - steps) / replays:.1f}% of the replays")


def check_sde_likelihood(port, model, device):
    """11.7: ODE bits/dim at B=32, rtol = atol = 1e-5 (the config's), the
    RK step captured: one evaluation's vjp launches nothing; the first solve
    (with the capture), then one more timed end to end (success, finite
    bpd, NFE, s a batch, the replays after ``done``, busy share and pool of
    the RK step); then the plain path's solve, captured, at the same
    tolerances on the same batch and probe: bpd within 2e-2 relative, both
    NFEs printed."""
    import torch

    from diffusion_model_nemo_tpu_torch.modules.sde_lib.score_fn import probability_flow_drift

    x0 = family_bpd_batch(device, SDE_LIK_B)
    lk = model.likelihood_estimator
    assert (lk.rtol, lk.atol) == (1e-5, 1e-5), (lk.rtol, lk.atol)
    eps = lk.draw_epsilon(x0.shape, torch.Generator(device=device).manual_seed(SEED), device)
    fn = model.get_model_fn(training=True)
    xg = x0.clone().requires_grad_(True)
    t = torch.tensor(0.5, device=device)
    port.ops.reset_launch_counts()
    drift = probability_flow_drift(fn, lk.sde, model.params, xg, t)
    torch.cuda.synchronize()
    fwd = {k: v for k, v in port.ops.launch_counts().items() if v}
    port.ops.reset_launch_counts()
    torch.autograd.grad(drift, xg, grad_outputs=eps)
    torch.cuda.synchronize()
    bwd = {k: v for k, v in port.ops.launch_counts().items() if v}
    log(f"[sde] likelihood evaluation B={SDE_LIK_B}: forward launches {json.dumps(fwd)}, vjp launches "
        f"{json.dumps(bwd)}")
    assert bwd == {} and set(fwd) == set(UNET_KERNELS)
    solve = lambda: lk.likelihood(fn, model.params, x0, epsilon=eps)  # noqa: E731
    first_s, _ = walled(solve)
    graph = graph_of(lk.graphs, "rk45")
    port.ops.reset_launch_counts()
    wall, (bpd, z, nfe), replays = solve_replays(graph, solve)
    counts = port.ops.launch_counts()
    nfe = int(nfe)
    # A replay costs the same before and after ``done``; few are traced,
    # since each adds its ~23k nodes' events to the profiler's processing.
    busy = replay_busy(graph, "step", 0, iters=SDE_LIK_PROFILE_REPLAYS)
    log(f"[sde] likelihood B={SDE_LIK_B} rtol=atol=1e-5: bpd mean {float(bpd.mean()):.5f} (finite "
        f"{bool(torch.isfinite(bpd).all())}), NFE {nfe}; {wall:.3f} s a batch captured (host clock, one solve: "
        f"{after_done_line(port, replays, nfe, wall)}); the first call with the capture {first_s:.3f} s")
    graph_line(f"score_sde likelihood RK step B={SDE_LIK_B} (per replay: 7 evaluations, each with its vjp)",
               wall / replays, busy, None, graph, counts, replays)
    assert bool(torch.isfinite(bpd).all()) and nfe > 0 and nfe % 7 == 0
    lk.graphs.clear()  # the kernel path's pool goes
    plain = type(lk)(hutchinson_type=lk.hutchinson_type, rtol=lk.rtol, atol=lk.atol, eps=lk.eps)
    plain.update_sde(model.sde)
    with plain_path(port):
        p_s, (bpd_p, _zp, nfe_p) = walled(lambda: plain.likelihood(fn, model.params, x0, epsilon=eps))
    plain.graphs.clear()
    rel = float(((bpd - bpd_p).abs() / bpd_p.abs()).max())
    log(f"[sde] likelihood rtol=atol=1e-5 kernels vs plain (both captured, the same batch and probe): bpd "
        f"{float(bpd.mean()):.5f} / {float(bpd_p.mean()):.5f}, max relative difference {rel:.3e} (tol "
        f"{SDE_BPD_TOL}); NFE kernels {nfe}, plain {int(nfe_p)}; plain {p_s:.3f} s with its capture")
    assert rel <= SDE_BPD_TOL and bool(torch.isfinite(bpd_p).all()) and int(nfe_p) > 0


def check_sde_probability_flow(port, model):
    """11.8: probability-flow sampling at B=64 with the denoising step,
    captured: NFE, seconds and the replays after ``done``."""
    import torch

    base = dict(model.cfg.sampler)
    model.change_sampler({"_target_": PF, "denoise": True})
    try:
        run = lambda: model.sample(SDE_B, 32, generator=torch.Generator(device=model.device).manual_seed(SEED),  # noqa: E731
                                   use_ema=True, return_nfe=True)
        first_s, _ = walled(run)
        graph = graph_of(model.sampler.graphs, "rk45")
        wall, (out, nfe), replays = solve_replays(graph, run)
    finally:
        model.change_sampler(base)
    log(f"[sde] probability flow B={SDE_B} (denoise): NFE {int(nfe)}, {wall:.3f} s a batch, "
        f"{SDE_B / wall:.2f} images/s ({after_done_line(port, replays, int(nfe), wall)}; first call with capture "
        f"{first_s:.3f} s); graph pool {graph.info['pool_mib']:.1f} MiB, {graph.info['nodes']} nodes; finite "
        f"{bool(torch.isfinite(out).all())}")
    assert bool(torch.isfinite(out).all()) and int(nfe) > 0


def check_sde_other_sdes(port, device):
    """11.9: sub-VP and VE: one forward against the plain path and a 50-step
    captured PC prefix == eager."""
    import torch

    for sde_type in ("subvpsde", "vesde"):
        model = sde_model(port, device, [f"model.sde.sde_type={sde_type}"])
        check_forward(port, f"score_sde {sde_type}", model, *sde_inputs(model, device), SDE_FWD_TOL)
        check_pc_prefix(port, sde_type, model, SDE_OTHER_PREFIX)


def check_sde_clis(port, tmp):
    """11.10: train_score_sde (a few steps at B=128, compute_bpd off) →
    eval_score_sde (B=64: PC, then probability flow) → test_score_sde (one
    batch of 8); none of NOT_ON_THE_CARD imported."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import eval_score_sde, test_score_sde, train_score_sde

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, trainer = train_score_sde.main([
        *CLI_MODEL, "model.train_ds.name=synthetic", "model.compute_bpd=false",
        f"trainer.max_steps={SDE_CLI_STEPS}", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp}/exp",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run"])
    cli_counts(port, "train_score_sde", UNET_KERNELS)
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    log(f"[sde] train_score_sde {SDE_CLI_STEPS} steps B={TRAIN_B}: {time.perf_counter() - t0:.2f} s, logged "
        f"{json.dumps(trainer.logged)}, archive {dmn.name}")
    assert len(trainer.logged) == SDE_CLI_STEPS and all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    for tag, extra in (("PC", []), ("probability flow", ["use_probability_flow_sampler=true"])):
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        out_dir, nfe = eval_score_sde.main([f"model_path={dmn}", f"batch_size={B}", f"output_dir={tmp}/samples",
                                            "add_timestamp=false", *extra])
        cli_counts(port, f"eval_score_sde {tag}", UNET_KERNELS)
        log(f"[sde] eval_score_sde {tag} B={B}: NFE {nfe}, {time.perf_counter() - t0:.2f} s with the restore")
        assert (out_dir / "samples_grid.png").exists() and nfe > 0
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = test_score_sde.main([f"model_path={dmn}", "limit_test_batches=1", f"batch_size={SDE_CLI_TEST_B}"])
    cli_counts(port, "test_score_sde", UNET_KERNELS)
    log(f"[sde] test_score_sde B={SDE_CLI_TEST_B}: {json.dumps(result)} in {time.perf_counter() - t0:.2f} s with "
        f"the restore")
    assert np.isfinite(result["test_total_bpd"]) and result["avg_num_forward_evaluations"] > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the ScoreSDE CLIs loaded {loaded}"


def check_score_sde(port, device, rows):
    """11. ScoreSDE at its shipped config's full width: its kernel sites
    (their max |diff| into ``rows``), forward, samplers, serving, training,
    likelihood, the other SDEs, the CLIs."""
    t11 = time.perf_counter()
    model = sde_model(port, device)
    log(f"[sde] ScoreSDE {type(model.sde).__name__} N={model.sde.N}, sampler {type(model.sampler).__name__} "
        f"({model.sampler.predictor} x {model.sampler.corrector})")
    per = check_sde_forward(port, model, device, rows)
    check_sde_em_chain(port, model, per)
    check_sde_combinations(port, model)
    tmp = tempfile.mkdtemp(prefix="dmn_sde_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        check_sde_serving(port, model, per, tmp)
        check_sde_training(port, model)
        check_sde_likelihood(port, model, device)
        check_sde_probability_flow(port, model)
        check_sde_other_sdes(port, device)
        check_sde_clis(port, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sde] phase 11 in {time.perf_counter() - t11:.1f} s")


# ------------------------------------------------------------ the WaveGrad family --
WG_CONFIG = "examples/configs/wavegrad_ddpm/unet_small.yaml"
VOC_CONFIG = "examples/configs/wavegrad_ddpm/vocoder.yaml"
WG_PREFIX = 100  # steps of the ancestral chain's captured prefix held to eager
WG_SHORT, WG_SEARCH_ITERS = 50, 100  # the sample dump's searched schedule
WG_BPD_B = 32
WG_SERVE_B = 16
WG_CLI_STEPS = 4  # train_wavegrad_ddpm: a dump (search, sample, restore, bits/dim) at the last step
VOC_B, VOC_VOCODE_ITERS = 32, 500  # vocoder.yaml's batch; the vocode CLI's search
VOC_STEPS = 3
VOC_F32_TOL = 2e-2  # the bf16 vocoder step's loss against the float32 run of the same weights and draws
VOC_SERVE_B = 8
VOC_CLI_STEPS = 3


def wg_model(port, device, config=WG_CONFIG, cls="WavegradDDPM", overrides=()):
    """A WaveGrad model from its shipped YAML at full width, random weights
    from ``SEED`` (the U-Net model at 32 px on the synthetic set)."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    extra = [*CLI_MODEL, "model.train_ds.name=synthetic"] if cls == "WavegradDDPM" else []
    cfg = load_config(Path(__file__).resolve().parent / config, overrides=[*extra, *overrides]).model
    return getattr(port.models, cls)(cfg, device=device, seed=SEED)


def wg_inputs(device, B=B):
    """x [B, 32, 32, 3] and continuous levels [B, 1, 1, 1] in (0, 1)."""
    import torch

    x, _ = model_inputs(device, 32, B)
    return x, torch.rand(B, 1, 1, 1, generator=torch.Generator(device=device).manual_seed(SEED), device=device)


def numpy_search(timesteps, short, cfg, iters, seed):
    """The JAX package's schedule search written out in numpy (linear
    schedule): the beta_end whose ``short``-step table ends nearest the
    original's last √ᾱ (float32), from ``RandomState(seed)`` candidates."""
    import numpy as np

    def last(T, end):
        betas = np.linspace(cfg["beta_start"], end, T, dtype=np.float64).astype(np.float32).astype(np.float64)
        return float(np.float32(np.sqrt(np.cumprod(1.0 - betas)[-1])))

    target, best, best_mae = last(timesteps, cfg["beta_end"]), cfg["beta_end"], 1e10
    rng = np.random.RandomState(seed)
    for _ in range(iters):
        cand = float(rng.uniform(0.0, 1.0))
        mae = abs(target - last(short, cand))
        if mae < best_mae:
            best, best_mae = cand, mae
    return best


def wg_chain(model, B, steps, graphs, seed=SEED):
    """The model's ancestral chain (the last ``steps`` steps, or all) on the
    EMA weights from a fresh generator: (images, generator state)."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.inference_mode():
        out = model.sampler.p_sample_loop(model.get_model_fn(), model.ema_params, (B, 32, 32, 3), g,
                                          num_steps=steps, graphs=graphs)
    return out, g.get_state()


def deterministic_equal(tag, run):
    """``run(graphs)`` eagerly, then captured twice (the first call
    captures), bit for bit under ``cudnn.deterministic``: (equal, eager s,
    first s, replayed s, the replayed result)."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager_s, ref = walled(lambda: run(False))
        first_s, first = walled(lambda: run(None))
        wall, out = walled(lambda: run(None))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a, b) for a, b in zip(ref, out)) and all(torch.equal(a, b) for a, b in zip(ref, first))
    log(f"[wavegrad] {tag}: captured == eager bit for bit (cudnn.deterministic): {same}; captured {wall:.3f} s, "
        f"eager {eager_s:.3f} s, first call with capture {first_s:.3f} s")
    assert same, f"{tag}: the captured loop differs from the eager loop"
    return out


def check_wg_forward(port, model, device, rows):
    """12.1: the WaveGrad U-Net's kernel calls at B=64 (#1-#4), each held
    against its plain version; one forward against the plain path.
    Returns the launches per forward."""
    x, level = wg_inputs(device)
    calls = record_calls(port, model, x, level)
    per = per_forward_counts(calls)
    log(f"[wavegrad] WaveGradUNet B={B}: launches a forward {json.dumps(per)} (FiLM convs: cuDNN, as XLA's in the "
        f"JAX package); {sum(len(v) for v in calls.values())} kernel shapes")
    assert set(per) == set(UNET_KERNELS), per
    for name, r in check_kernels(port, {"wavegrad": calls}).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], r["max_abs_err"])
    check_forward(port, "wavegrad (continuous levels)", model, x, level, UNET_REL_TOL)
    return per


def check_wg_training(port, model):
    """12.2: one B=128 step with the kernels against the plain path (loss
    1e-2, whole gradient 2e-2, no launch in the backward), then the
    captured step's ms, busy and pool."""
    per = derived_counts(port, model, TRAIN_B, 32)
    batch, draws = training_batch(model, TRAIN_B)
    assert set(draws) == {"flip", "s", "u", "noise"}, set(draws)
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts("wavegrad step forward", fwd, per)
    assert_counts("wavegrad step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _f, _b, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss, rel_grad = abs(loss_k - loss_p) / abs(loss_p), float((g_k - g_p).norm() / g_p.norm())
    log(f"[wavegrad] step B={TRAIN_B} kernels vs plain: loss {loss_k:.6f} / {loss_p:.6f} (rel {rel_loss:.3e}, tol "
        f"{LOSS_REL_TOL}); whole gradient rel_l2 {rel_grad:.3e} (tol {FAMILY_GRAD_TOL})")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= FAMILY_GRAD_TOL
    family_step_timing(port, "wavegrad", model)


def check_wg_chains(port, model, per):
    """12.3-12.4: the ancestral chain at B=64: a captured prefix == eager,
    the 1000-step chain captured (wall, busy a step, launches); the
    searched 50-step schedule (beta_end == the numpy search) and its chain
    on the same sampler, captured == eager; the restore."""
    import torch

    sampler = model.sampler
    T = sampler.timesteps
    deterministic_equal(f"ancestral prefix {WG_PREFIX} steps B={B}", lambda g: wg_chain(model, B, WG_PREFIX, g))
    run = lambda: wg_chain(model, B, None, None)  # noqa: E731
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, (out, _) = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(sampler.graphs, "ancestral")
    busy, by_name = replay_profile(graph, "t", T - 1)
    log_device_split(by_name, 1, f"WaveGrad ancestral step B={B}", "[wavegrad]")
    log(f"[wavegrad] ancestral T={T} B={B}: {wall:.3f} s a chain, {B / wall:.2f} images/s (first call with capture "
        f"{first_s:.3f} s); finite {bool(torch.isfinite(out).all())}, std {float(out.std()):.4f}")
    graph_line(f"wavegrad ancestral T={T} B={B} (per step)", wall / T, busy, None, graph, counts, T - 1,
               extra=dict(graph.delta))
    assert counts == {k: per.get(k, 0) * T for k in counts}, (counts, per)
    original, held, old_table = sampler.constants, dict(sampler.graphs), {id(t) for t in sampler.table_tensors()}
    linear = dict(sampler.original_schedule_cfg["linear"])
    expect = numpy_search(T, WG_SHORT, linear, WG_SEARCH_ITERS, 0)
    t0 = time.perf_counter()
    sampler.use_searched_schedule(WG_SHORT, WG_SEARCH_ITERS, seed=0)
    search_s = time.perf_counter() - t0
    got = sampler.schedule_cfg["linear"]["beta_end"]
    log(f"[wavegrad] searched {WG_SHORT}-step schedule ({WG_SEARCH_ITERS} candidates, seed 0, {search_s:.3f} s on "
        f"the host): beta_end {got!r}, the numpy search's {expect!r}; last sqrt(alpha_bar) "
        f"{float(sampler.constants.sqrt_alphas_cumprod_prev[-1]):.6f} against the {T}-step "
        f"{float(original.sqrt_alphas_cumprod_prev[-1]):.6f}")
    assert got == expect and sampler.timesteps == WG_SHORT
    try:
        port.ops.reset_launch_counts()
        short_out = deterministic_equal(f"searched {WG_SHORT}-step chain B={B} on the sampler that holds the "
                                        f"{T}-step graph", lambda g: wg_chain(model, B, None, g))
        new = [g for k, g in sampler.graphs.items() if k not in held]
        assert new and not old_table & {id(t) for t in new[-1].sources}, "the 50-step graph reads the old table"
        assert bool(torch.isfinite(short_out[0]).all())
    finally:
        sampler.restore_schedule()
    assert sampler.constants is original and sampler.timesteps == T
    assert all(sampler.graphs.get(k) is g for k, g in held.items()), "the restore recaptured the 1000-step graph"
    log(f"[wavegrad] restored: T={sampler.timesteps}, the original table tensors, the {T}-step graph kept")


def check_wg_bpd(port, model, device):
    """12.5: bits/dim at T = 1000, B = 32 through WaveGrad's p_mean_variance,
    captured (s a batch, busy), against the plain path (captured too, the
    same noise) within 2e-2."""
    import torch

    x0 = family_bpd_batch(device, WG_BPD_B)
    T = model.sampler.timesteps
    run = lambda: model.calculate_bits_per_dimension(x0)  # noqa: E731
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, kern = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "bpd")
    busy = replay_busy(graph, "t", T - 1)
    graph_line(f"wavegrad bpd T={T} B={WG_BPD_B} (per step)", wall / T, busy, None, graph, counts, T)
    model.sampler.graphs.clear()  # the plain path captures its own graph
    with plain_path(port):
        plain_s, plain = walled(run)
    model.sampler.graphs.clear()
    rel = float(((kern["total_bpd"] - plain["total_bpd"]).abs() / plain["total_bpd"].abs()).max())
    log(f"[wavegrad] bits/dim T={T} B={WG_BPD_B}: total_bpd kernels {float(kern['total_bpd'].mean()):.5f} plain "
        f"{float(plain['total_bpd'].mean()):.5f}, max relative difference {rel:.3e} (tol "
        f"{BPD_REL_TOL['bfloat16']:.0e}); {wall:.3f} s a batch captured (first call with capture {first_s:.3f} s), "
        f"plain path {plain_s:.3f} s with its capture")
    assert rel <= BPD_REL_TOL["bfloat16"] and bool(torch.isfinite(kern["terms_bpd"]).all())


def check_wg_serving(port, model, tmp):
    """12.6: the model saved, restored by ``restore_model_from_archive`` and
    served on its own ancestral chain: one /sample; launches = per forward
    x 1000 x batches."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve

    path = model.save_to(str(Path(tmp) / "WavegradDDPM.dmn"))
    restored = port.models.restore_model_from_archive(path, device=model.device)
    assert type(restored).__name__ == "WavegradDDPM"
    assert all(restored.params[k].equal(v) for k, v in model.params.items())
    per = derived_counts(port, restored, WG_SERVE_B, 32)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(restored, port=0, max_batch=WG_SERVE_B, use_ddim_sampler=False, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    try:
        t1 = time.perf_counter()
        code, body = http("POST", f"http://{server.host}:{server.port}/sample", {"num_images": 4, "seed": 9,
                                                                                 "format": "npy"})
        wall = time.perf_counter() - t1
        stats = json.loads(http("GET", f"http://{server.host}:{server.port}/stats")[1])
    finally:
        server.shutdown()
    npy = np.load(io.BytesIO(body))
    counts = port.ops.launch_counts()
    batches, T = stats["batches"] + 1, restored.sampler.timesteps
    log(f"[wavegrad] serve WavegradDDPM archive (ancestral T={T}, max_batch={WG_SERVE_B}): warm-up {warm_s:.2f} s, "
        f"/sample {code} in {wall:.3f} s, {list(npy.shape)}")
    assert code == 200 and npy.shape == (4, 32, 32, 3) and npy.std() > 0
    assert counts == {k: per.get(k, 0) * T * batches for k in counts}, (counts, per, batches)


def check_wg_clis(port, tmp):
    """12.7: train_wavegrad_ddpm (B=128, a dump at the last step: the 50-step
    search and chain, the restore, bits/dim at T = 1000), eval_wavegrad_ddpm
    (a searched 50-step schedule, B=64), test_wavegrad_ddpm (bits/dim on a
    searched 50-step schedule, B=32)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import eval_wavegrad_ddpm, test_wavegrad_ddpm, train_wavegrad_ddpm

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, trainer = train_wavegrad_ddpm.main([
        *CLI_MODEL, "model.train_ds.name=synthetic", f"model.save_every={WG_CLI_STEPS}",
        f"trainer.max_steps={WG_CLI_STEPS}", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp}/exp",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run"])
    train_s = time.perf_counter() - t0
    cli_counts(port, "train_wavegrad_ddpm", UNET_KERNELS)
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    dumps = sorted(p.name for p in Path(tmp).glob("results/*/sample-*.png"))
    log(f"[wavegrad] train_wavegrad_ddpm {WG_CLI_STEPS} steps B={TRAIN_B}: {train_s:.2f} s with the dump "
        f"(search, 16 x 50 steps at B=4, restore, bits/dim at T=1000); logged {json.dumps(trainer.logged)}; dump "
        f"{dumps}; sampler back at T={model.sampler.timesteps}; the config's searched beta_end "
        f"{model.cfg.sampler.schedule_cfg.linear.beta_end} (the JAX package's property, kept)")
    assert dumps and model.sampler.timesteps == 1000 and all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eval_wavegrad_ddpm.main([f"model_path={dmn}", f"batch_size={B}", f"output_dir={tmp}/samples",
                                   "add_timestamp=false"])
    cli_counts(port, "eval_wavegrad_ddpm", UNET_KERNELS)
    log(f"[wavegrad] eval_wavegrad_ddpm (search 1000 candidates, 50 steps, B={B}): {time.perf_counter() - t0:.2f} s "
        f"with the restore")
    assert (out / "samples_grid.png").exists()
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = test_wavegrad_ddpm.main([f"model_path={dmn}", "limit_test_batches=1", f"batch_size={WG_BPD_B}"])
    cli_counts(port, "test_wavegrad_ddpm", UNET_KERNELS)
    log(f"[wavegrad] test_wavegrad_ddpm (search 50 steps): {json.dumps(result)} in {time.perf_counter() - t0:.2f} s")
    assert np.isfinite(result["test_total_bpd"])


def voc_batch(model, B=VOC_B):
    """A batch of the synthetic audio set ({"audio": [B, 7200]}) and the
    step's draws."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.data import SyntheticAudioDataset

    ds = SyntheticAudioDataset(model.segment_length, length=B)
    batch = {"audio": np.stack([ds[i]["audio"] for i in range(B)])}
    draws = model.draw_training_inputs(batch["audio"].shape, torch.Generator(device=model.device).manual_seed(SEED))
    return batch, draws


def check_voc_training(port, model, device):
    """12.8: the vocoder's B=32 step: the bf16 loss against the float32 run
    of the same weights and draws; ``VOC_STEPS`` captured steps == eager
    steps bit for bit (cudnn.deterministic); the captured step's ms, busy,
    pool. No hand kernel runs (its convolutions are cuDNN's, as XLA's in
    the JAX package)."""
    import torch

    from diffusion_model_nemo_tpu_torch.modules.parts import Conv1d

    flops = []
    hooks = [m.register_forward_hook(lambda m, _i, y: flops.append(2 * y.numel() * m.weight[0].numel()))
             for m in model.diffusion_model.modules() if isinstance(m, Conv1d)]
    with torch.inference_mode():
        model.vocoder_fn(model.params, torch.zeros(1, model.segment_length, 1, device=device),
                         torch.full((1, 1, 1), 0.5, device=device), torch.zeros(1, model.segment_frames, model.n_mels,
                                                                                 device=device))
    for h in hooks:
        h.remove()
    log(f"[vocoder] {sum(p.numel() for p in model.params.values()) / 1e6:.2f} M parameters; the convolutions of a "
        f"forward: {sum(flops) / 1e9:.2f} GFLOP a sample (counted from shapes)")
    batch, draws = voc_batch(model)
    f32 = wg_model(port, device, VOC_CONFIG, "WavegradVocoderModel", ["model.diffusion_model.dtype=float32"])
    f32.params = {k: v.clone() for k, v in model.params.items()}
    with torch.no_grad():
        port.ops.reset_launch_counts()
        loss_b = float(model.training_step(model.params, batch, draws)[0])
        launched = {k: v for k, v in port.ops.launch_counts().items() if v}
        loss_f = float(f32.training_step(f32.params, batch, draws)[0])
    rel = abs(loss_b - loss_f) / abs(loss_f)
    log(f"[vocoder] step B={VOC_B} T={model.segment_length}: loss bf16 {loss_b:.6f}, float32 {loss_f:.6f} (rel "
        f"{rel:.3e}, tol {VOC_F32_TOL}); hand kernels launched {launched}")
    assert rel <= VOC_F32_TOL and launched == {}

    def steps(graphs):
        trainer = port.Trainer(max_steps=VOC_STEPS, devices=1)
        state = trainer.init_state(model, VOC_STEPS)
        losses = [trainer.train_step(model, state, batch, draws, graphs=graphs)["train_loss"]
                  for _ in range(VOC_STEPS)]
        return (*state.params.values(), torch.stack(losses))

    deterministic_equal(f"vocoder {VOC_STEPS} training steps B={VOC_B}", steps)
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
    state = trainer.init_state(model, TRAIN_STEPS)
    run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
    wall = time_ms(run, iters=20)
    busy, by_name = device_profile(run, iters=5)
    log_device_split(by_name, 1, f"vocoder training step B={VOC_B}", "[vocoder]")
    info = graph_of(state.graphs, "train_step").info
    log(f"[vocoder] captured step B={VOC_B}: wall {wall:.3f} ms (CUDA events), {VOC_B / wall * 1e3:.1f} samples/s; "
        f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); graph pool {info['pool_mib']:.1f} MiB, "
        f"{info['nodes']} nodes, capture {info['capture_s']:.3f} s")


def check_voc_vocode(port, model, device):
    """12.9: ``vocode`` of a B=32 batch's mel at the searched 50-step
    schedule (500 candidates, the vocode CLI's): captured == eager bit for
    bit (cudnn.deterministic), s a batch, busy a step, pool."""
    import torch

    batch, _ = voc_batch(model)
    mel = model.compute_mel(torch.from_numpy(batch["audio"]).to(device))
    sampler = model.sampler
    t0 = time.perf_counter()
    sampler.use_searched_schedule(WG_SHORT, VOC_VOCODE_ITERS, seed=0)
    search_s = time.perf_counter() - t0
    try:
        run = lambda g: (model.vocode(mel, generator=torch.Generator(device=device).manual_seed(SEED),  # noqa: E731
                                      graphs=g),)
        out = deterministic_equal(f"vocode searched {WG_SHORT} steps B={VOC_B}", run)[0]
        first_s, _ = walled(lambda: run(None))  # captures (cudnn's settings key the graph)
        port.ops.reset_launch_counts()
        wall, _ = walled(lambda: run(None))
        counts = port.ops.launch_counts()
        graph = graph_of(sampler.graphs, "ancestral")
        busy, by_name = replay_profile(graph, "t", WG_SHORT - 1)
        log_device_split(by_name, 1, f"vocoder ancestral step B={VOC_B}", "[vocoder]")
        log(f"[vocoder] vocode B={VOC_B} mel {list(mel.shape)} -> {list(out.shape)}: searched beta_end "
            f"{sampler.schedule_cfg['linear']['beta_end']!r} ({search_s:.3f} s), {wall:.3f} s a batch, "
            f"{VOC_B * model.segment_length / wall / model.sample_rate:.1f} s of audio a second (first call with "
            f"capture {first_s:.3f} s); finite "
            f"{bool(torch.isfinite(out).all())}, std {float(out.std()):.4f}")
        graph_line(f"vocoder vocode {WG_SHORT} steps B={VOC_B} (per step)", wall / WG_SHORT, busy, None, graph, counts,
                   WG_SHORT - 1, extra=dict(graph.delta))
        assert out.shape == (VOC_B, model.segment_length) and bool(torch.isfinite(out).all())
    finally:
        sampler.restore_schedule()


def check_voc_serving_and_archive(port, model, tmp):
    """12.10-12.11: the archive round-trips bit for bit; served (its own
    1000-step chain, max_batch 8): a seeded /vocode answers float32
    waveforms, repeats, and /sample answers 400."""
    import urllib.error

    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve

    path = model.save_to(str(Path(tmp) / "Vocoder.dmn"))
    restored = port.models.restore_model_from_archive(path, device=model.device)
    same = type(restored).__name__ == "WavegradVocoderModel" and all(
        restored.params[k].equal(v) and restored.ema_params[k].equal(model.ema_params[k])
        for k, v in model.params.items())
    log(f"[vocoder] archive {Path(path).name} restored by restore_model_from_archive: params and EMA bit for bit "
        f"{same}")
    assert same
    t0 = time.perf_counter()
    server = serve(restored, port=0, max_batch=VOC_SERVE_B, use_ddim_sampler=False, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    mel = np.asarray(restored.compute_mel(restored.mel_fb.new_tensor(voc_batch(restored, 4)[0]["audio"])).cpu())
    buf = io.BytesIO()
    np.save(buf, mel)
    payload = {"mel_npy": base64.b64encode(buf.getvalue()).decode(), "seed": 11}
    try:
        t1 = time.perf_counter()
        code, body = http("POST", base + "/vocode", payload)
        wall = time.perf_counter() - t1
        again = http("POST", base + "/vocode", payload)[1]
        try:
            http("POST", base + "/sample", {"num_images": 1})
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
    finally:
        server.shutdown()
    waves = np.load(io.BytesIO(body))
    log(f"[vocoder] serve vocoder archive (T={restored.sampler.timesteps}, max_batch={VOC_SERVE_B}): warm-up "
        f"{warm_s:.2f} s, /vocode {code} in {wall:.3f} s -> {list(waves.shape)} {waves.dtype}, seeded repeat equal "
        f"{np.array_equal(waves, np.load(io.BytesIO(again)))}, /sample answered {refused}")
    assert code == 200 and waves.shape == (4, restored.segment_length) and waves.dtype == np.float32
    assert np.array_equal(waves, np.load(io.BytesIO(again))) and refused == 400


def check_voc_clis(port, tmp):
    """12.12: train_vocoder (a few steps at B=32), then vocode (the searched
    50-step schedule, 500 candidates, a batch of 4)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import train_vocoder, vocode

    t0 = time.perf_counter()
    _model, trainer = train_vocoder.main([
        f"trainer.max_steps={VOC_CLI_STEPS}", "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp}/exp",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run"])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    log(f"[vocoder] train_vocoder {VOC_CLI_STEPS} steps B={VOC_B}: {time.perf_counter() - t0:.2f} s, logged "
        f"{json.dumps(trainer.logged)}, archive {dmn.name}")
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    t0 = time.perf_counter()
    out_dir, out = vocode.main([f"model_path={dmn}", f"output_dir={tmp}/vocoded"])
    log(f"[vocoder] vocode CLI: {list(out.shape)} in {time.perf_counter() - t0:.2f} s with the restore and search")
    assert np.isfinite(out).all() and (out_dir / "vocoded.npy").exists()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the WaveGrad CLIs loaded {loaded}"


def check_wavegrad(port, device, rows):
    """12. WavegradDDPM at examples/configs/wavegrad_ddpm/unet_small.yaml
    (32 px) and the vocoder at vocoder.yaml, full width, random weights
    from ``SEED``: kernels, training, chains on the full and the searched
    schedule, bits/dim, archives, serving, the five CLIs."""
    t12 = time.perf_counter()
    model = wg_model(port, device)
    log(f"[wavegrad] WavegradDDPM: {type(model.diffusion_model).__name__}, {type(model.sampler).__name__} "
        f"{model.sampler.schedule_name} T={model.sampler.timesteps}")
    per = check_wg_forward(port, model, device, rows)
    check_wg_training(port, model)
    check_wg_chains(port, model, per)
    check_wg_bpd(port, model, device)
    tmp = tempfile.mkdtemp(prefix="dmn_wavegrad_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        check_wg_serving(port, model, tmp)
        check_wg_clis(port, tmp)
        log(f"[wavegrad] WavegradDDPM in {time.perf_counter() - t12:.1f} s")
        vocoder = wg_model(port, device, VOC_CONFIG, "WavegradVocoderModel")
        check_voc_training(port, vocoder, device)
        check_voc_vocode(port, vocoder, device)
        check_voc_serving_and_archive(port, vocoder, tmp)
        check_voc_clis(port, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[wavegrad] phase 12 in {time.perf_counter() - t12:.1f} s")


# ----------------------------------------------------- the sampling services --
SVC = {  # sampler: (_target_ suffix, fields), the served defaults of each flag
    "ddim": ("GeneralizedGaussianDiffusion", {"eta": 0.0, "ddim_timesteps": DDIM_STEPS}),
    "dpm": ("DPMSolverDiffusion", {"solver_steps": 20, "solver_order": 2}),
    "unipc": ("UniPCDiffusion", {"solver_steps": 20, "solver_order": 2, "use_corrector": True}),
    "karras": ("KarrasDiffusion", {"solver_steps": 18, "solver_order": 2}),
}
SVC_FLAGS = {"ddim": {}, "dpm": {"use_dpm_solver": True}, "unipc": {"use_unipc": True},
             "karras": {"use_karras_sampler": True}}
SVC_GRAPH = {"ddim": "ddim", "dpm": "dpm_solver", "unipc": "unipc", "karras": "karras_heun"}
SVC_WINDOW_S = 3.0  # each served sampler's window: concurrent clients send /sample requests until it closes
SVC_CLIENT_SIZES = (16, 48, 32, 32)  # one client a size: its requests' num_images, coalesced into batches of B
FRAMES_PREFIX = 50  # the ancestral chain's last steps held eager against captured, with frames
EDIT_STRENGTHS = (0.25, 0.75)
EDIT_EAGER_STRENGTH = 0.05  # t0 = 50: the partial chain held eager against captured
REPAINT_B, REPAINT_PREFIX = 8, 200  # RePaint's batch; its schedule's first entries held eager against captured
SVC_CLI_B = 8
UNET_KERNELS = ("group_norm_silu", "linear_attention_block", "linear_attention_tokens", "attention_block_small")


def svc_sampler(model, base, name, **extra):
    target, fields = SVC[name]
    model.change_sampler(dict(base, _target_=f"diffusion_model_nemo.modules.{target}", **fields, **extra))


def svc_nfe(model, name):
    """Network calls a chain: DDIM's and the multistep solvers' M, Karras
    Heun's 2M − 1."""
    if name == "ddim":
        return len(model.sampler._strided_sequences()[0])
    coefs = model.sampler._unipc_coefficients() if name == "unipc" else model.sampler._solver_coefficients()
    M = len(next(iter(coefs.values())))
    return 2 * M - 1 if name == "karras" else M


class deterministic:
    """``cudnn.deterministic`` on inside the block (a graph captured there
    is keyed on it: a capture of its own)."""

    def __enter__(self):
        import torch

        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self.was


def svc_generator(model, seed=SEED):
    import torch

    return torch.Generator(device=model.device).manual_seed(seed)


def check_fast_sampler(port, model, base, name, per):
    """13a. One sampler at B=64 (EMA weights): captured == eager bit for bit
    twice (cudnn.deterministic); then captured and eager wall, device busy,
    NFE, launches = the graph's per-step counts x replays (the graph's
    counts = one forward's x forwards a step), images/s. Returns the line's
    numbers."""
    import torch

    svc_sampler(model, base, name)
    nfe = svc_nfe(model, name)
    run = lambda graphs=None: model.sample(B, 32, generator=svc_generator(model), use_ema=True,  # noqa: E731
                                           graphs=graphs)
    with deterministic():
        ref, first, again = run(False), run(), run()
    same = torch.equal(ref, first) and torch.equal(ref, again)
    assert same and bool(torch.isfinite(ref).all()) and float(ref.std()) > 0, name
    eager_s, _ = walled(lambda: run(False))
    first_s, _ = walled(run)  # the capture
    port.ops.reset_launch_counts()
    wall, out = walled(run, n=3)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, SVC_GRAPH[name])
    busy, _ = device_profile(run, iters=1)
    per_step = 2 if name == "karras" else 1
    assert graph.delta == {k: v * per_step for k, v in per.items()}, (name, graph.delta, per)
    replays = nfe if name != "karras" else (nfe - 1) // 2
    extra = {k: 3 * v for k, v in per.items()} if name == "karras" else None  # the last Euler step's graph
    graph_line(f"svc {name} B={B} NFE {nfe} (first call with capture {first_s:.3f} s; == eager bit for bit under "
               f"cudnn.deterministic)", wall, busy / 1e3, eager_s, graph, counts, 3 * replays, extra)
    log(f"[svc] {name} B={B}: NFE {nfe}, captured {wall * 1e3:.3f} ms a chain ({B / wall:.2f} images/s), device busy "
        f"{busy:.3f} ms ({busy / nfe:.3f} ms a network call), eager {eager_s * 1e3:.3f} ms; launches a step "
        f"{json.dumps(graph.delta)} = {per_step} x one forward's {json.dumps(per)}")
    return {"nfe": nfe, "wall_ms": wall * 1e3, "busy_ms": busy, "eager_ms": eager_s * 1e3}


def client_window(server, tag):
    """One client a size of SVC_CLIENT_SIZES, each sending unseeded /sample
    requests back to back until SVC_WINDOW_S closes, so that the server
    coalesces them into batches: (answers [(code, n, good)], the window's
    wall to the last answer, /stats once its count has caught up, images
    answered). Every answer must be a 200 of n uint8 32-px images."""
    import numpy as np

    url = f"http://{server.host}:{server.port}"
    answers, errors = [], []

    def client(n, deadline):
        try:
            while time.perf_counter() < deadline:
                code, body = http("POST", url + "/sample", {"num_images": n, "format": "npy"})
                a = np.load(io.BytesIO(body))
                answers.append((code, n, a.shape == (n, 32, 32, 3) and a.dtype == np.uint8 and a.std() > 0))
        except Exception as e:  # reported below, after the other clients
            errors.append(repr(e))

    t1 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(n, t1 + SVC_WINDOW_S)) for n in SVC_CLIENT_SIZES]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive(), f"{tag}: a /sample client did not finish"
    wall = time.perf_counter() - t1
    images = sum(n for _, n, _ in answers)
    for _ in range(100):  # a batch's count lands just after its requests are answered
        stats = json.loads(http("GET", url + "/stats")[1])
        if stats["images"] == images:
            break
        time.sleep(0.05)
    assert not errors, (tag, errors)
    assert answers and all(code == 200 and good for code, _, good in answers), tag
    assert stats["images"] == images and stats["requests"] == len(answers), (tag, stats, images, len(answers))
    return answers, wall, stats, images


def check_fast_serving(port, model, base, name, per, nfe):
    """13b. ``serve`` with the sampler's flag (its defaults), max_batch 64,
    over a window of SVC_WINDOW_S: one client a size of SVC_CLIENT_SIZES,
    each sending unseeded /sample requests back to back until the window
    closes, so that the server coalesces them into batches. images/s = every
    image answered / the window's wall (to the last answer); launches = one
    forward's x NFE x batches (the warm-up's included)."""
    from diffusion_model_nemo_tpu_torch.serving import serve

    model.change_sampler(base)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS, use_ema=True, **SVC_FLAGS[name])
    warm_s = time.perf_counter() - t0
    assert type(model.sampler).__name__ == SVC[name][0], (name, type(model.sampler).__name__)
    server.start_background()
    try:
        answers, wall, stats, images = client_window(server, name)
    finally:
        server.shutdown()
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    batches = stats["batches"] + 1
    expect = {k: v * nfe * batches for k, v in per.items()}
    served = {"images_s": images / wall, "requests": len(answers), "images": images, "batches": stats["batches"],
              "fill": stats["avg_batch_fill"], "batch_ms": wall * 1e3 / stats["batches"],
              "latency_ms": stats["avg_request_latency_ms"], "device_ms": stats["avg_device_ms_per_batch"]}
    log(f"[svc] serve {name} max_batch={B}: warm-up {warm_s:.2f} s; {len(SVC_CLIENT_SIZES)} concurrent clients "
        f"(num_images {list(SVC_CLIENT_SIZES)}) over {wall:.3f} s: {len(answers)} requests, {images} images in "
        f"{stats['batches']} batches (fill {stats['avg_batch_fill']}), {served['images_s']:.2f} images/s served, "
        f"{served['batch_ms']:.3f} ms a batch; avg device ms a batch {stats['avg_device_ms_per_batch']}, latency "
        f"{stats['avg_request_latency_ms']} ms; launches {json.dumps(counts)} = one forward's x {nfe} x {batches} "
        f"batches")
    assert counts == expect, (name, counts, expect)
    return served


def check_guided_dpm(port, device):
    """13c. The guided ConditionalDDPM (label 3, w = 3) under DPM-Solver++ at
    B=64: one 2B forward a step (the labels a static buffer of the graph),
    captured == eager bit for bit (cudnn.deterministic), wall and busy."""
    import torch

    model = family_model(port, device, "conditional")
    base = dict(model.cfg.sampler)
    svc_sampler(model, base, "dpm")
    per = derived_counts(port, model, 2 * B, 32)
    run = lambda graphs=None: model.sample(B, 32, generator=svc_generator(model), label=COND_LABEL,  # noqa: E731
                                           guidance_scale=COND_SCALE, use_ema=True, graphs=graphs)
    with deterministic():
        ref, first = run(False), run()
    assert torch.equal(ref, first) and float(ref.std()) > 0, "guided DPM: captured differs from eager"
    walled(run)
    port.ops.reset_launch_counts()
    wall, _ = walled(run, n=2)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "dpm_solver")
    busy, _ = device_profile(run, iters=1)
    M = svc_nfe(model, "dpm")
    graph_line(f"svc guided conditional DPM-{M} B={B} label {COND_LABEL} w={COND_SCALE} (== eager bit for bit)",
               wall, busy / 1e3, None, graph, counts, 2 * M)
    assert graph.delta == per, (graph.delta, per)
    log(f"[svc] guided DPM-{M} B={B}: {wall * 1e3:.3f} ms a chain, {B / wall:.2f} images/s, busy {busy:.3f} ms")


def check_improved_refusal(port, device):
    """13d. ImprovedDDPM's [B, H, W, 2C] output: DPM, UniPC and Karras each
    refuse it with a ValueError that names the cause (the JAX loops fail in
    a reshape)."""
    model = family_model(port, device, "improved")
    base = dict(model.cfg.sampler)
    for name in ("dpm", "unipc", "karras"):
        svc_sampler(model, base, name)
        try:
            model.sample(2, 32, generator=svc_generator(model))
        except ValueError as e:
            assert "learned-variance" in str(e), str(e)
            log(f"[svc] improved under {name}: ValueError: {str(e)[:100]}...")
        else:
            raise AssertionError(f"{name} sampled a learned-variance network")


def check_frames(port, model, base):
    """13e. ``return_frames``: the ancestral chain's last FRAMES_PREFIX steps
    at B=64, captured == eager bit for bit, frames included
    (cudnn.deterministic); the whole T = 1000 chain captured with its
    frames (wall, the frames' bytes, peak memory), the last frame the
    output; DPM-20's frames captured == eager."""
    import torch

    model.change_sampler(dict(base, _target_=ANCESTRAL))
    sampler, T = model.sampler, model.sampler.timesteps

    def chain(graphs, n):
        return sampler.p_sample_loop(model.get_model_fn(), model.ema_params, (B, 32, 32, 3), svc_generator(model),
                                     num_steps=n, graphs=graphs, return_frames=True)

    with torch.inference_mode(), deterministic():
        (o1, f1), (o2, f2) = chain(False, FRAMES_PREFIX), chain(True, FRAMES_PREFIX)
    assert torch.equal(o1, o2) and torch.equal(f1, f2) and torch.equal(f2[-1], o2), "ancestral frames differ"
    with torch.inference_mode():
        first_s, _ = walled(lambda: chain(True, None))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        wall, (out, frames) = walled(lambda: chain(True, None))
        peak = (torch.cuda.max_memory_allocated() - before) / 2**20
    assert frames.shape == (T, B, 32, 32, 3) and torch.equal(frames[-1], out) and bool(torch.isfinite(frames).all())
    log(f"[svc] ancestral T={T} B={B} return_frames: last {FRAMES_PREFIX} steps captured == eager bit for bit "
        f"(frames too); the whole chain captured {wall:.3f} s (first call with capture {first_s:.3f} s), frames "
        f"{frames.numel() * 4 / 2**20:.1f} MiB, peak {peak:.1f} MiB over the call")
    del frames
    svc_sampler(model, base, "dpm")
    with deterministic():
        (a, fa), (b, fb) = (model.sample(B, 32, generator=svc_generator(model), use_ema=True, graphs=g,
                                         return_frames=True) for g in (False, True))
    assert torch.equal(a, b) and torch.equal(fa, fb) and fb.shape[0] == svc_nfe(model, "dpm")
    log(f"[svc] DPM B={B} return_frames: {list(fb.shape)}, captured == eager bit for bit")


def check_interpolation(port, model, base, device):
    """13f. Interpolation: ancestral (q-space lerp at t, the chain's last t
    steps) at t = FRAMES_PREFIX captured == eager (cudnn.deterministic) and
    at the default t = T − 1 captured (wall); DDIM-50 from 8 slerped
    latents captured == eager."""
    import torch

    from diffusion_model_nemo_tpu_torch.cli.interpolate_ddim import slerp

    model.change_sampler(dict(base, _target_=ANCESTRAL))
    x = family_bpd_batch(device, 2 * B)
    x1, x2 = x[:B], x[B:]
    run = lambda graphs=None, t=None: model.interpolate(x1, x2, t=t, generator=svc_generator(model),  # noqa: E731
                                                        graphs=graphs)
    with deterministic():
        assert torch.equal(run(False, FRAMES_PREFIX), run(True, FRAMES_PREFIX)), "interpolation differs"
    first_s, _ = walled(run)
    wall, out = walled(run)
    assert bool(torch.isfinite(out).all())
    svc_sampler(model, base, "ddim")
    g = svc_generator(model)
    z1, z2 = (torch.randn(32, 32, 3, generator=g, device=device) for _ in range(2))
    latents = torch.stack([slerp(z1, z2, a) for a in torch.linspace(0.0, 1.0, 8).tolist()])
    with deterministic():
        a, b = (model.interpolate(latents, latents, graphs=gr) for gr in (False, True))
    assert torch.equal(a, b), "DDIM interpolation differs"
    log(f"[svc] interpolate ancestral B={B}: t={FRAMES_PREFIX} captured == eager bit for bit; t=T-1 "
        f"{wall:.3f} s captured (first call with capture {first_s:.3f} s); DDIM-{DDIM_STEPS} slerp of 8 latents "
        f"captured == eager bit for bit")


def check_edit_serving(port, model, base, per):
    """13g. SDEdit: at strength EDIT_EAGER_STRENGTH captured == eager
    (cudnn.deterministic); then POST /edit on a DDIM-configured server (the
    partial chain is the ancestral one) at each of EDIT_STRENGTHS: a seeded
    request twice (the same bytes), two unseeded ones coalesced into one
    batch; launches = one forward's x t0 x batches; every strength replays
    the one ancestral graph (its capture s, pool); the 400s (a DDPM
    archive's /super_resolve among them)."""
    import urllib.error

    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.serving import serve

    model.change_sampler(base)
    imgs = np.random.default_rng(SEED).integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    src = torch.from_numpy(imgs).to(model.device).float() / 255.0
    with deterministic():
        a, b = (model.edit(src, EDIT_EAGER_STRENGTH, generator=svc_generator(model), use_ema=True, graphs=g)
                for g in (False, True))
    assert torch.equal(a, b), "edit: captured differs from eager"
    server = serve(model, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS, use_ema=True)
    server.start_background()
    url = f"http://{server.host}:{server.port}"

    def b64(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return base64.b64encode(buf.getvalue()).decode()

    def status(path, payload):
        try:
            return http("POST", url + path, payload)[0]
        except urllib.error.HTTPError as e:
            return e.code

    def ancestral():
        return {id(g): g for k, g in model.sampler.graphs.items() if k[0] == "ancestral" and k[2] == imgs.shape}

    try:
        seen = None
        for s in EDIT_STRENGTHS:
            t0 = int(round(s * (model.timesteps - 1)))
            replays = {i: g.info["replays"] for i, g in ancestral().items()}
            before = json.loads(http("GET", url + "/stats")[1])["batches"]
            port.ops.reset_launch_counts()
            seeded = {"images_npy": b64(imgs), "strength": s, "seed": 7, "format": "npy"}
            t1 = time.perf_counter()
            first = http("POST", url + "/edit", seeded)[1]
            first_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            second = http("POST", url + "/edit", seeded)[1]
            wall = time.perf_counter() - t1
            results = {}

            def request(k, n):
                results[k] = http("POST", url + "/edit", {"images_npy": b64(imgs[:n]), "strength": s,
                                                          "format": "npy"})

            # Held until both are queued: the linger window (5 ms) is no
            # promise that two HTTP clients arrive within it.
            threads = [threading.Thread(target=request, args=(k, n)) for k, n in (("a", 20), ("b", 30))]
            with server.batcher.hold():
                for th in threads:
                    th.start()
                deadline = time.perf_counter() + 60
                while server.batcher.queued() < 2:
                    assert time.perf_counter() < deadline, "the unseeded /edit requests were not queued"
                    time.sleep(0.001)
            for th in threads:
                th.join(timeout=600)
                assert not th.is_alive(), "an unseeded /edit request did not finish"
            batches = json.loads(http("GET", url + "/stats")[1])["batches"] - before
            counts = {k: v for k, v in port.ops.launch_counts().items() if v}
            out = np.load(io.BytesIO(first))
            assert first == second and out.shape == imgs.shape and out.dtype == np.uint8, s
            assert sorted(np.load(io.BytesIO(r[1])).shape[0] for r in results.values()) == [20, 30]
            assert batches == 3, (s, batches)
            expect = {k: v * t0 * batches for k, v in per.items()}
            assert counts == expect, (s, counts, expect)
            used = [g for i, g in ancestral().items() if g.info["replays"] > replays.get(i, 0)]
            assert len(used) == 1, (s, len(used))
            info, captured = used[0].info, id(used[0]) not in replays
            assert seen is None or not captured and id(used[0]) == seen, f"strength {s} captured a graph of its own"
            seen = id(used[0])
            log(f"[svc] /edit strength {s} (t0 = {t0}) B={B}: first {first_s:.3f} s (the ancestral graph, "
                f"{'captured here' if captured else 'replayed, captured before'}: capture {info['capture_s']:.3f} "
                f"s, {info['nodes']} nodes, pool {info['pool_mib']:.1f} MiB), seeded again {wall:.3f} s, the same "
                f"bytes; two unseeded requests coalesced into one batch; launches {json.dumps(counts)} = one "
                f"forward's x {t0} x {batches}; |edit - input| mean {np.abs(out / 255.0 - imgs / 255.0).mean():.4f}")
        codes = {
            "strength 1.5": status("/edit", {"images_npy": b64(imgs[:2]), "strength": 1.5}),
            "shape [2,16,16,3]": status("/edit", {"images_npy": b64(imgs[:2, :16, :16]), "strength": 0.5}),
            "float 0-255": status("/edit", {"images_npy": b64(imgs[:2].astype(np.float32)), "strength": 0.5}),
            "no images_npy": status("/edit", {"strength": 0.5}),
            "/super_resolve": status("/super_resolve", {}),
        }
    finally:
        server.shutdown()
    log(f"[svc] /edit refusals: {json.dumps(codes)}")
    assert codes == {"strength 1.5": 400, "shape [2,16,16,3]": 400, "float 0-255": 400, "no images_npy": 400,
                     "/super_resolve": 400}, codes


def check_repaint(port, model, base, per8):
    """13h. RePaint at B=8 with the default jumps (10 x 10, T = 1000): the
    schedule's first REPAINT_PREFIX entries captured == eager bit for bit
    (cudnn.deterministic); the whole schedule captured (wall, reverse
    entries = network calls, launches = one forward's x reverse entries,
    the reverse step's device busy); the known region equal to the input
    exactly."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.cli.inpaint_ddpm import build_mask
    from diffusion_model_nemo_tpu_torch.modules.repaint import repaint_schedule, run_schedule

    model.change_sampler(dict(base, _target_=ANCESTRAL))
    sampler = model.sampler
    t_op, is_rev = repaint_schedule(sampler.timesteps, 10, 10)
    n_rev = int(is_rev.sum())
    imgs = np.random.default_rng(SEED + 1).integers(0, 256, (REPAINT_B, 32, 32, 3)).astype(np.uint8)
    known = torch.from_numpy(imgs).to(model.device).float() / 255.0
    mask = torch.from_numpy(build_mask("center", known.shape, 0.5, svc_generator(model))).to(model.device)
    with torch.inference_mode(), deterministic():
        a, b = (run_schedule(sampler, model.get_model_fn(), model.ema_params, known * 2 - 1, mask,
                             t_op[:REPAINT_PREFIX], is_rev[:REPAINT_PREFIX], svc_generator(model),
                             graphs=g).clone() for g in (False, True))
    assert torch.equal(a, b), "RePaint: captured prefix differs from eager"
    port.ops.reset_launch_counts()
    wall, out = walled(lambda: model.inpaint(known, mask, generator=svc_generator(model), use_ema=True))
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    keep = mask.expand_as(known) > 0
    ref = ((known * 2.0 - 1.0) + 1.0) * 0.5
    exact = torch.equal(out[keep], ref[keep])
    reverse = graph_of(sampler.graphs, "repaint_reverse")
    busy = replay_busy(reverse, "i", 0)
    log(f"[svc] RePaint B={REPAINT_B} jumps 10 x 10: {len(t_op)} entries, {n_rev} reverse (network calls); first "
        f"{REPAINT_PREFIX} entries captured == eager bit for bit; the whole schedule captured {wall:.3f} s (with "
        f"both captures: {reverse.info['capture_s']:.3f} s, pool {reverse.info['pool_mib']:.1f} MiB), "
        f"{wall / n_rev * 1e3:.3f} ms a reverse entry, its replay {busy * 1e3:.3f} ms busy; known region == input "
        f"exactly: {exact}; launches {json.dumps(counts)}")
    assert n_rev == 9910 and exact and bool(torch.isfinite(out).all())
    assert counts == {k: v * n_rev for k, v in per8.items()}, (counts, per8)


def check_service_clis(port, device, model, base, tmp):
    """13i. The five new CLIs and eval_ddpm with each sampler flag and
    show_diffusion, from archives of this unet_small and an ImprovedDDPM
    at full width, each writing its files; none of PyYAML, msgpack, flax,
    orbax or Pillow imported."""
    from diffusion_model_nemo_tpu_torch.cli import (
        edit_ddpm, eval_ddpm, inpaint_ddpm, interpolate_ddim, interpolate_ddpm, interpolate_improved_ddpm,
    )

    model.change_sampler(dict(base, _target_=ANCESTRAL))
    dmn = model.save_to(f"{tmp}/DDPM.dmn")
    idmn = family_model(port, device, "improved").save_to(f"{tmp}/ImprovedDDPM.dmn")
    b = f"batch_size={SVC_CLI_B}"
    runs = [
        ("eval_ddpm use_dpm_solver", eval_ddpm, [f"model_path={dmn}", b, "use_dpm_solver=true"], "samples_grid.png"),
        ("eval_ddpm use_karras_sampler", eval_ddpm, [f"model_path={dmn}", b, "use_karras_sampler=true"],
         "samples_grid.png"),
        ("eval_ddpm use_unipc", eval_ddpm, [f"model_path={dmn}", b, "use_unipc=true"], "samples_grid.png"),
        ("eval_ddpm show_diffusion", eval_ddpm, [f"model_path={dmn}", b, "show_diffusion=true"], "diffusion.gif"),
        ("interpolate_ddpm", interpolate_ddpm, [f"model_path={dmn}", b, "dataset_name=synthetic"],
         "interpolation.png"),
        ("interpolate_improved_ddpm", interpolate_improved_ddpm, [f"model_path={idmn}", b, "dataset_name=synthetic"],
         "interpolation.png"),
        ("interpolate_ddim", interpolate_ddim, [f"model_path={dmn}", "num_interpolations=8"], "slerp.png"),
        ("edit_ddpm", edit_ddpm, [f"model_path={dmn}", b, "strength=0.5"], "edited.png"),
        ("inpaint_ddpm", inpaint_ddpm, [f"model_path={dmn}", b, "jump_n_sample=2"], "inpainted.png"),
    ]
    for i, (tag, cli, argv, expect) in enumerate(runs):
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        stamp = [] if cli.__name__.split(".")[-1].startswith("interpolate") else ["add_timestamp=false"]
        out = cli.main([*argv, f"output_dir={tmp}/out{i}", *stamp])
        secs = time.perf_counter() - t0
        cli_counts(port, tag, UNET_KERNELS)
        data = (Path(out) / expect).read_bytes()
        assert data[:4] in (b"\x89PNG", b"GIF8"), (tag, data[:8])
        log(f"[svc] {tag}: {secs:.2f} s with the restore, {expect} {len(data)} bytes")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the sampling services' CLIs loaded {loaded}"
    log(f"[svc] none of {', '.join(NOT_ON_THE_CARD)} was imported")


def check_sampling_services(port, models, device):
    """13. The DDPM family's sampling services on unet_small at full width
    (bf16, random weights from seed 0)."""
    t13 = time.perf_counter()
    model = models["unet_small"]
    model.change_sampler(dict(model.cfg.sampler, _target_=ANCESTRAL))
    base = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    per = derived_counts(port, model, B, 32)
    rows = {name: check_fast_sampler(port, model, base, name, per) for name in SVC}
    served = {name: check_fast_serving(port, model, base, name, per, rows[name]["nfe"]) for name in SVC}
    log("[svc] | sampler | NFE | captured ms a batch | device busy ms | eager ms | images/s served | requests | "
        "batches (fill) | served ms a batch | of which beyond the captured chain |")
    for name, r in rows.items():
        v = served[name]
        log(f"[svc] | {name} | {r['nfe']} | {r['wall_ms']:.3f} | {r['busy_ms']:.3f} | {r['eager_ms']:.3f} | "
            f"{v['images_s']:.2f} | {v['requests']} | {v['batches']} ({v['fill']}) | {v['batch_ms']:.3f} | "
            f"{v['batch_ms'] - r['wall_ms']:.3f} |")
    check_guided_dpm(port, device)
    check_improved_refusal(port, device)
    check_frames(port, model, base)
    check_interpolation(port, model, base, device)
    check_edit_serving(port, model, base, per)
    check_repaint(port, model, base, derived_counts(port, model, REPAINT_B, 32))
    tmp = tempfile.mkdtemp(prefix="dmn_svc_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        check_service_clis(port, device, model, base, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[svc] phase 13 in {time.perf_counter() - t13:.1f} s")


# ------------------------------------------- the training options and services --
OPT_YAML = "examples/configs/ddpm/unet_small.yaml"
OPTIONS = ["+model.snr_gamma=5.0", "+model.offset_noise_strength=0.1", "model.diffusion_model.dropout=0.1"]
PRED_V = ["+model.sampler.objective=pred_v", "+model.sampler.zero_terminal_snr=true"]
OPT_STEPS = 3  # steps held captured against eager (eager twice: its spread)
ACCUM_K, ACCUM_B = 2, 64  # K micro-batches of 64: unet_small's batch of 128
ZTSNR_B = 64
PHEMA_SIGMAS, PHEMA_STEPS, PHEMA_EVERY = (0.05, 0.10), 6, 3
PREFETCH_STEPS, PREFETCH_LOG = 16, 4  # a fit logging every 4 steps; steps 4 ... 8 traced
PROFILE_START, PROFILE_NUM = 4, 4
GUIDANCE_SCALES = (1.5, 4.0)
DEFAULT_STEP_MS = (27.601, 24.937)  # the default B=128 step's wall and busy ms before the options (H100, PERF.md)


def options_model(port, device, overrides=()):
    """DDPM from examples/configs/ddpm/unet_small.yaml at 32 px, full width,
    random weights from ``SEED``, with ``overrides``."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / OPT_YAML,
                      overrides=[*CLI_MODEL, "model.train_ds.name=synthetic", *overrides]).model
    return port.DDPM(cfg, device=device, seed=SEED)


def state_spread(run):
    """``run(graphs)`` → a train state, eager twice and captured once:
    (eager repeats itself, max |eager − eager|, captured == eager, max
    |captured − eager|) over the parameters and the EMA."""
    import torch

    e1, e2, g = run(False), run(False), run(None)

    def tensors(st):
        return [*st.params.values(), *st.ema_params.values()]

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(tensors(a), tensors(b)))

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b)))

    return equal(e1, e2), diff(e1, e2), equal(g, e1), diff(g, e1)


def steps_run(port, model, batches, accum=1):
    """``run(graphs)``: OPT_STEPS optimizer steps of a fresh train state on
    ``batches`` (one a step, stacked [K, ...] under accumulation), the draws
    from a generator seeded with ``SEED``; returns the state."""
    import torch

    def run(graphs):
        trainer = port.Trainer(max_steps=OPT_STEPS, devices=1, seed=SEED, accumulate_grad_batches=accum)
        state = trainer.init_state(model, OPT_STEPS)
        gen = torch.Generator(device=model.device).manual_seed(SEED)
        for batch in batches:
            shape = batch["image"].shape[1:] if accum > 1 else batch["image"].shape
            draws = [model.draw_training_inputs(shape, gen) for _ in range(accum)]
            trainer.train_step(model, state, batch, trainer.stack_draws(draws) if accum > 1 else draws[0],
                               graphs=graphs)
        torch.cuda.synchronize()
        return state

    return run


def check_option_step(port, tag, model, expect_draws):
    """14a. One B=128 step with the options, kernels against the plain path
    (loss, whole gradient; the backward launches nothing); OPT_STEPS
    captured steps within eager's spread; the captured step's wall and
    busy."""
    batch, draws = training_batch(model, TRAIN_B)
    assert expect_draws <= set(draws), (tag, sorted(draws))
    per = derived_counts(port, model, TRAIN_B, 32)
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts(f"{tag} step forward", fwd, per)
    assert_counts(f"{tag} step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _f, _b, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss, rel_grad = abs(loss_k - loss_p) / abs(loss_p), float((g_k - g_p).norm() / g_p.norm())
    ee, ee_diff, ge, ge_diff = state_spread(steps_run(port, model, [batch] * OPT_STEPS))
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
    state = trainer.init_state(model, TRAIN_STEPS)
    run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
    wall = time_ms(run, iters=20)
    busy, _by_name = device_profile(run, iters=5)
    graph = graph_of(state.graphs, "train_step")
    log(f"[opts] {tag} step B={TRAIN_B}: loss kernels {loss_k:.6f} plain {loss_p:.6f} (rel {rel_loss:.3e}, tol "
        f"{LOSS_REL_TOL}); gradient rel_l2 {rel_grad:.3e} (tol {GRAD_REL_TOL}); {OPT_STEPS} steps eager twice "
        f"bit-equal {ee} (max |diff| {ee_diff:.3e}), captured vs eager bit-equal {ge} (max |diff| {ge_diff:.3e}); "
        f"captured step {wall:.3f} ms wall, {busy:.3f} ms busy ({TRAIN_B / wall * 1e3:.1f} samples/s; the default "
        f"step before the options: {DEFAULT_STEP_MS[0]} / {DEFAULT_STEP_MS[1]} ms); graph {graph.info['nodes']} nodes, "
        f"pool {graph.info['pool_mib']:.1f} MiB, {len(state.graphs)} graph(s)")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    assert ge if ee else ge_diff <= ee_diff, f"{tag}: the captured steps left the eager ones' bounds"
    return wall, busy


def check_ztsnr_chain(port, model):
    """14b. pred_v + zero terminal SNR: ᾱ_T = 0 in the table; DDIM-50 at
    B=64 captured == eager bit for bit (cudnn.deterministic), finite."""
    import torch

    use_sampler(model, DDIM, eta=0.0, ddim_timesteps=DDIM_STEPS)
    assert model.sampler.objective == "pred_v" and model.sampler.zero_terminal_snr
    acp = model.sampler.constants.alphas_cumprod
    run = lambda graphs=None: model.sample(  # noqa: E731
        ZTSNR_B, 32, generator=torch.Generator(device=model.device).manual_seed(SEED), graphs=graphs)
    with deterministic():
        eager_s, ref = walled(lambda: run(False))
        first_s, first = walled(run)
        wall, out = walled(run)
    assert torch.equal(first, ref) and torch.equal(out, ref), "zero-terminal-SNR DDIM: captured differs from eager"
    assert bool(torch.isfinite(out).all()) and float(out.std()) > 0
    log(f"[opts] pred_v + zero_terminal_snr DDIM-{DDIM_STEPS} B={ZTSNR_B}: alphas_cumprod[T-1] = "
        f"{float(acp[-1])} (1/alphas_cumprod there: {float(model.sampler.constants.sqrt_recip_alphas_cumprod[-1])}); "
        f"captured == eager bit for bit, finite; eager {eager_s:.3f} s, first (capture) {first_s:.3f} s, "
        f"replayed {wall * 1e3:.3f} ms")


def check_accumulation(port, model):
    """14c. K = 2 micro-batches of 64 as one step: the accumulated gradient
    and loss against one B=128 step on the same samples and draws; the
    captured K = 2 step within eager's spread; its wall and samples/s."""
    import torch

    batch, draws = training_batch(model, TRAIN_B)
    stack = lambda v: v.reshape(ACCUM_K, ACCUM_B, *v.shape[1:])  # noqa: E731
    batch_k, draws_k = {k: stack(v) for k, v in batch.items()}, {k: stack(v) for k, v in draws.items()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    one, acc = port.Trainer(devices=1), port.Trainer(devices=1, accumulate_grad_batches=ACCUM_K)
    g1, m1 = one.grads(model, params, batch, draws)
    gk, mk = acc.grads(model, params, batch_k, draws_k)
    flat = lambda g: torch.cat([v.float().flatten() for v in g.values()])  # noqa: E731
    rel_loss = abs(float(mk["train_loss"]) - float(m1["train_loss"])) / abs(float(m1["train_loss"]))
    rel_grad = float((flat(gk) - flat(g1)).norm() / flat(g1).norm())
    ee, ee_diff, ge, ge_diff = state_spread(steps_run(port, model, [batch_k] * OPT_STEPS, accum=ACCUM_K))
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1, accumulate_grad_batches=ACCUM_K)
    state = trainer.init_state(model, TRAIN_STEPS)
    run = lambda: trainer.train_step(model, state, batch_k, draws_k)  # noqa: E731
    wall = time_ms(run, iters=10)
    busy, _ = device_profile(run, iters=3)
    graph = graph_of(state.graphs, "train_step")
    log(f"[opts] accumulation K={ACCUM_K} x {ACCUM_B}: loss {float(mk['train_loss']):.6f} against one B={TRAIN_B} "
        f"step's {float(m1['train_loss']):.6f} (rel {rel_loss:.3e}, tol {LOSS_REL_TOL}); gradient rel_l2 "
        f"{rel_grad:.3e} (tol {GRAD_REL_TOL}); {OPT_STEPS} steps eager twice bit-equal {ee} (max |diff| "
        f"{ee_diff:.3e}), captured vs eager bit-equal {ge} (max |diff| {ge_diff:.3e}); the captured step (one graph, "
        f"{graph.info['nodes']} nodes, pool {graph.info['pool_mib']:.1f} MiB) {wall:.3f} ms wall, {busy:.3f} ms "
        f"busy, {ACCUM_K * ACCUM_B / wall * 1e3:.1f} samples/s")
    assert len(state.graphs) == 1 and rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    assert ge if ee else ge_diff <= ee_diff, "accumulation: the captured steps left the eager ones' bounds"


def check_posthoc_ema(port, device, tmp):
    """14d. Post-hoc EMA at two σ_rel over a PHEMA_STEPS-step fit (snapshots
    every PHEMA_EVERY and at the end); ``reconstruct_ema`` writes a .dmn,
    whose restored model serves a DDIM-50 batch; the update's cost in the
    captured step (with and without it, one call)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.tools import reconstruct_ema
    from diffusion_model_nemo_tpu_torch.training.posthoc_ema import PostHocEMA

    model = options_model(port, device)
    phema_dir = os.path.join(tmp, "phema")
    trainer = port.Trainer(max_steps=PHEMA_STEPS, log_every_n_steps=0, devices=1, seed=SEED,
                           posthoc_ema_sigma_rels=list(PHEMA_SIGMAS), posthoc_ema_every_n_steps=PHEMA_EVERY,
                           posthoc_ema_dir=phema_dir)
    trainer.fit(model)
    snaps = sorted(os.listdir(phema_dir))
    assert len(snaps) == len(PHEMA_SIGMAS) * (PHEMA_STEPS // PHEMA_EVERY), snaps
    out = reconstruct_ema.main(["--archive", model.save_to(os.path.join(tmp, "base.dmn")), "--snapshots", phema_dir,
                                "--sigma_rel", "0.08", "--output", os.path.join(tmp, "sr008.dmn")])
    restored = port.DDPM.restore_from(out, use_ema=True, device=device)
    server = serve(restored, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS)
    server.start_background()
    try:
        served = np.load(io.BytesIO(http("POST", f"http://{server.host}:{server.port}/sample",
                                         {"num_images": 4, "seed": 3, "format": "npy"})[1]))
    finally:
        server.shutdown()
    assert served.shape == (4, 32, 32, 3) and served.dtype == np.uint8 and served.std() > 0
    batch, draws = training_batch(model, TRAIN_B)
    ms = {}
    for tracked in (False, True):
        tr = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
        state = tr.init_state(model, TRAIN_STEPS)
        if tracked:
            tr.phema = PostHocEMA(os.path.join(tmp, "timing"), PHEMA_SIGMAS, 0, network=model.diffusion_model)
            state.phema = tr.phema.init_state(state.params)
        ms[tracked] = time_ms(lambda: tr.train_step(model, state, batch, draws), iters=20)
    log(f"[opts] post-hoc EMA sigma_rels {PHEMA_SIGMAS} over {PHEMA_STEPS} steps: snapshots {snaps}; "
        f"reconstruct_ema sigma_rel 0.08 -> {os.path.basename(out)}, served DDIM-{DDIM_STEPS} (4 images, std "
        f"{served.std():.2f}); captured step {ms[False]:.3f} ms without, {ms[True]:.3f} ms with the update "
        f"({ms[True] - ms[False]:.3f} ms a step for {len(PHEMA_SIGMAS)} averages, one call)")


def check_profile_and_prefetch(port, device, tmp):
    """14e/14f. A PREFETCH_STEPS-step fit at B=128 through the prefetcher
    (batches pinned in its thread) with ``profile_dir`` tracing steps
    PROFILE_START ... +PROFILE_NUM: the trace is written and holds device
    kernels; samples/s of the untraced logs; the window's device idle share
    (1 − kernel time / the window's wall, the trace's own overhead
    included)."""
    import torch

    from diffusion_model_nemo_tpu_torch.tools.profiling import WindowTrace

    window = {}

    class Timed(WindowTrace):
        def start(self):
            torch.cuda.synchronize()
            window["start"] = time.perf_counter()
            super().start()

        def stop(self, path):
            torch.cuda.synchronize()
            window["stop"] = time.perf_counter()
            window["events"] = super().stop(path)
            return window["events"]

    model = options_model(port, device)
    trace_dir = os.path.join(tmp, "trace")
    trainer = port.Trainer(max_steps=PREFETCH_STEPS, log_every_n_steps=PREFETCH_LOG, devices=1, seed=SEED,
                           profile_dir=trace_dir, profile_start_step=PROFILE_START, profile_num_steps=PROFILE_NUM)
    with mock.patch.object(port.training.trainer, "WindowTrace", Timed):
        trainer.fit(model)
    torch.cuda.synchronize()
    files = os.listdir(trace_dir)
    assert files == [f"trace-steps-{PROFILE_START}-{PROFILE_START + PROFILE_NUM}.json"], files
    assert json.loads(Path(trace_dir, files[0]).read_text())["traceEvents"]
    kernels = window["events"]  # the window's device events, the markers left out (WindowTrace.stop)
    busy_ms = sum(us for _name, us in kernels) / 1e3
    wall_ms = (window["stop"] - window["start"]) * 1e3
    logged = {m["global_step"]: m["samples_per_sec"] for m in trainer.logged}
    # the log after the window also holds the trace's export on the host
    untraced = [v for step, v in logged.items() if step > PROFILE_START + PROFILE_NUM + PREFETCH_LOG]
    log(f"[opts] fit {PREFETCH_STEPS} steps B={TRAIN_B} through the prefetcher: samples/s by log "
        f"{json.dumps({k: round(v, 1) for k, v in logged.items()})} (untraced: {[round(v, 1) for v in untraced]}); "
        f"profile_dir trace {files[0]} ({os.path.getsize(os.path.join(trace_dir, files[0])) / 2**20:.1f} MiB): "
        f"{len(kernels)} device events, {busy_ms:.3f} ms busy over the window's {wall_ms:.3f} ms wall, device "
        f"idle share {100 * (1 - busy_ms / wall_ms):.1f}% (profiler overhead included)")
    assert kernels and busy_ms > 0 and untraced and all(v > 0 for v in untraced)


def check_guidance_repair(port, device):
    """14g. One guided graph for every scale: a conditional server answers
    /sample at two guidance scales (seeded); the second scale replays the
    graph the first captured and captures nothing."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve

    model = family_model(port, device, "conditional")
    server = serve(model, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS, use_ema=True)
    server.start_background()

    def guided():
        return {id(g): g for k, g in model.sampler.graphs.items()
                if any(getattr(part, "__name__", "") == "_cfg_forward" for part in k)}

    outs, seen = {}, None
    try:
        for w in GUIDANCE_SCALES:
            replays = {i: g.info["replays"] for i, g in guided().items()}
            n_graphs = len(model.sampler.graphs)
            t0 = time.perf_counter()
            outs[w] = np.load(io.BytesIO(http("POST", f"http://{server.host}:{server.port}/sample", {
                "num_images": 4, "label": COND_LABEL, "guidance_scale": w, "seed": COND_SEED, "format": "npy"})[1]))
            wall = time.perf_counter() - t0
            used = [g for i, g in guided().items() if g.info["replays"] > replays.get(i, 0)]
            assert len(used) == 1, (w, len(used))
            captured = id(used[0]) not in replays
            assert seen is None or (not captured and id(used[0]) == seen and len(model.sampler.graphs) == n_graphs), \
                f"guidance scale {w} captured a graph of its own"
            seen = id(used[0])
            log(f"[opts] conditional /sample label {COND_LABEL} w={w} B={B}: {wall:.3f} s, the guided DDIM graph "
                f"{'captured here' if captured else 'replayed (captured at the first scale)'} (capture "
                f"{used[0].info['capture_s']:.3f} s, pool {used[0].info['pool_mib']:.1f} MiB); graphs held "
                f"{len(model.sampler.graphs)}")
    finally:
        server.shutdown()
    assert len(guided()) == 1 and not np.array_equal(*outs.values())


def check_training_options(port, device):
    """14. The DDPM family's training options and the Trainer's services on
    unet_small at B=128 (bf16, full width, random weights from seed 0)."""
    t14 = time.perf_counter()
    opts = options_model(port, device, OPTIONS)
    sites = {f"dropout/{k}" for k in opts.diffusion_model.dropout_shapes((TRAIN_B, 32, 32, 3))}
    assert len(sites) == 17, sorted(sites)  # 8 down, 2 mid, 6 up, final_block
    check_option_step(port, "snr_gamma 5 + offset 0.1 + dropout 0.1", opts, {"offset", *sites})
    pred_v = options_model(port, device, PRED_V)
    check_option_step(port, "pred_v + zero_terminal_snr", pred_v, {"noise"})
    check_ztsnr_chain(port, pred_v)
    check_accumulation(port, opts)
    tmp = tempfile.mkdtemp(prefix="dmn_opts_")
    try:
        check_posthoc_ema(port, device, tmp)
        check_profile_and_prefetch(port, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_guidance_repair(port, device)
    log(f"[opts] phase 14 in {time.perf_counter() - t14:.1f} s")


# ------------------------------------------------- the ConvNeXt U-Net and EDM --
EDM_YAML = "examples/configs/edm/unet_small.yaml"
CONVNEXT = ["model.diffusion_model.use_convnext=true", "model.diffusion_model.convnext_mult=2"]
# A ConvNeXt U-Net forward: #1 only at final_norm (its blocks' GroupNorm(1)s
# are plain ops), the attention blocks as in unet_small.
CONVNEXT_PER = {"group_norm_silu": 1, "linear_attention_block": 4, "linear_attention_tokens": 1,
                "attention_block_small": 1}
EDM_CHURN = {"s_churn": 40.0, "s_tmin": 0.05, "s_tmax": 50.0, "s_noise": 1.003}  # the paper's ImageNet-64 churn
EDM_AUG = ["+model.augment_prob=0.12", "+model.diffusion_model.aug_dim=9"]
EDM_LIK_B = 32
EDM_BPD_TOL = 2e-2  # bits/dim, kernels vs plain path, relative, bf16
EDM_INTERP_B = 16
EDM_CLI_B, EDM_CLI_STEPS = 8, 3
EDM_SCALES = (1.5, 4.0)
EDM_SERVE_SEED = 5


def edm_model(port, device, overrides=()):
    """EDM (ConditionalEDM with ``num_classes``) from
    examples/configs/edm/unet_small.yaml at 32 px, full width (dim 32,
    [1, 2, 4, 8], bf16, the ResNet U-Net), random weights from ``SEED``."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / EDM_YAML,
                      overrides=[*CLI_MODEL, "model.train_ds.name=synthetic", *overrides]).model
    cls = port.models.ConditionalEDM if cfg.get("num_classes") else port.models.EDM
    return cls(cfg, device=device, seed=SEED)


def hold_kernels(port, calls_by_cfg, rows, tag="edm", timed=False):
    """Each recorded call's kernel against its plain version on the same
    inputs (``agreement``); the largest error goes into the kernel's row.
    ``timed``: also the call's device ms (CUDA events around 20 calls queued
    behind a spin, so the host's launch time is hidden) and its bound."""
    table = kernel_table(port)
    for cfg_name, calls in calls_by_cfg.items():
        for name, shapes in calls.items():
            mod, attr, plain, _src, _rep = table[name]
            for key, (count, args) in sorted(shapes.items()):
                wrapper = getattr(mod, attr)
                _out, max_err, tol, ok, seam = agreement(name, wrapper, plain, args)
                timing = ""
                if timed:
                    nbytes, ops, kind = work(name, args)
                    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
                    timing = (f" device_ms={queued_us(lambda: wrapper(*args)) / 1e3:.5f} (queued events) bound_ms="
                              f"{max(t_bytes, t_ops):.5f} ({'bytes' if t_bytes >= t_ops else 'operations'})")
                log(f"[{tag}] kernel {cfg_name} {name} {list(key)} x{count}/forward max_abs_err={max_err:.3e} "
                    f"ok={ok} (tol {tol}){seam}{timing}")
                assert ok, (cfg_name, name, key)
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_err)


def step_against_plain(port, tag, model, per, card):
    """One B=128 training step with the kernels against the plain path
    (loss 1e-2, whole gradient 5e-2), nothing launched in the backward;
    then the captured step (``Trainer.train_step``): its graph launches one
    forward's kernels (none in its backward), its wall and device busy."""
    batch, draws = training_batch(model, TRAIN_B)
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts(f"{tag} step forward", fwd, per)
    assert_counts(f"{tag} step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _f, _b, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss, rel_grad = abs(loss_k - loss_p) / abs(loss_p), float((g_k - g_p).norm() / g_p.norm())
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
    state = trainer.init_state(model, TRAIN_STEPS)
    run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
    wall = time_ms(run, iters=20)
    busy, _ = device_profile(run, iters=2)
    graph = graph_of(state.graphs, "train_step")
    log(f"[edm] {tag} step B={TRAIN_B} draws {sorted(k for k in draws if not k.startswith('dropout/'))}: loss "
        f"kernels {loss_k:.6f} plain {loss_p:.6f} (rel {rel_loss:.3e}, tol {LOSS_REL_TOL}); gradient "
        f"({g_k.numel()} values) rel_l2 {rel_grad:.3e} (tol {GRAD_REL_TOL}); captured step {wall:.3f} ms wall, "
        f"{busy:.3f} ms busy ({100 * busy / wall:.1f}%), {TRAIN_B / wall * 1e3:.1f} samples/s, graph launches "
        f"{json.dumps(graph.delta)}, {graph.info['nodes']} nodes, pool {graph.info['pool_mib']:.1f} MiB "
        f"[{card}]")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    assert graph.delta == per, (tag, graph.delta, per)


def check_convnext(port, device, rows, card):
    """15a. unet_small with ConvNeXt blocks (examples/configs/ddpm/
    unet_small.yaml, use_convnext, convnext_mult 2): launches a forward at
    B=64 and 128, kernels held at both, the B=64 forward against the plain
    path, the captured DDIM-50 chain against eager, the B=128 step."""
    model = options_model(port, device, CONVNEXT)
    assert type(model.diffusion_model.down_0_block1).__name__ == "ConvNextBlock"
    x, t = model_inputs(device, 32)
    calls = {"convnext": record_calls(port, model, x, t),
             "convnext_128": record_calls(port, model, *model_inputs(device, 32, TRAIN_B))}
    per = {k: per_forward_counts(c) for k, c in calls.items()}
    log(f"[edm] convnext unet_small launches a forward (B={B}, B={TRAIN_B}): {json.dumps(per)}; the gates "
        f"(meta forward): {json.dumps(derived_counts(port, model, B, 32))}")
    assert per["convnext"] == per["convnext_128"] == CONVNEXT_PER == derived_counts(port, model, B, 32)
    lapped("15a kernels held", hold_kernels, port, calls, rows)
    check_forward(port, "convnext unet_small", model, x, t, UNET_REL_TOL)
    lapped("15a DDIM-50", check_graph_ddim, port, "convnext unet_small", model, B, 32, 1)
    lapped("15a step", step_against_plain, port, "convnext unet_small", model, CONVNEXT_PER, card)


def edm_chain(model, graphs=None, noise=None, seed=SEED):
    return model.sample(B, 32, generator=svc_generator(model, seed), use_ema=True, graphs=graphs, noise=noise)


def check_edm_chain(port, tag, model, per, card, noise=None):
    """15b. Algorithm 2 at B=64 (EMA weights): captured == eager bit for bit
    twice (cudnn.deterministic); the captured and eager walls, device busy,
    NFE; launches = the graphs' counts x replays (Heun: two forwards a
    step, the last Euler step a graph of its own)."""
    import torch

    s = model.sampler
    M, heun = s.sample_steps, s.solver == "heun"
    nfe = 2 * M - 1 if heun else M
    run = lambda graphs=None: edm_chain(model, graphs, noise)  # noqa: E731
    with deterministic():
        eager_s, ref = walled(lambda: run(False))
        first, again = run(), run()
    assert torch.equal(ref, first) and torch.equal(ref, again), f"{tag}: captured differs from eager"
    assert bool(torch.isfinite(ref).all()) and float(ref.std()) > 0, tag
    first_s, _ = walled(run)  # the capture
    port.ops.reset_launch_counts()
    wall, _ = walled(run, n=3)
    counts = port.ops.launch_counts()
    graph = graph_of(s.graphs, "edm_heun" if heun else "edm_euler")
    busy, _ = device_profile(run, iters=1)
    steps = M - 1 if heun else M
    assert graph.delta == {k: v * (2 if heun else 1) for k, v in per.items()}, (tag, graph.delta, per)
    graph_line(f"edm {tag} B={B} NFE {nfe} (first call with capture {first_s:.3f} s; == eager bit for bit under "
               f"cudnn.deterministic; the eager wall under it)", wall, busy / 1e3, eager_s, graph, counts, 3 * steps,
               {k: 3 * v for k, v in per.items()} if heun else None)
    log(f"[edm] {tag} B={B}: NFE {nfe}, captured {wall * 1e3:.3f} ms a chain ({B / wall:.1f} images/s), device busy "
        f"{busy:.3f} ms ({busy / nfe:.3f} ms a network call, {100 * busy / (wall * 1e3):.1f}% of the wall), eager "
        f"{eager_s * 1e3:.3f} ms [{card}]")
    return ref


def check_edm_likelihood(port, model, device, per, card):
    """15c. Bits/dim at B=32 through the probability-flow ODE (Heun on the
    17 transitions of the ascending grid, NFE 34): the captured step
    (forward and εᵀJε backward) replayed, launches = two forwards a step
    and nothing in the backward, equal to the eager loop bit for bit, and
    against the plain path (captured on a sampler of its own, so that no
    graph of one path replays for the other)."""
    import torch

    x0 = family_bpd_batch(device, EDM_LIK_B)
    eps = model.sampler.draw_epsilon(x0.shape, torch.Generator(device=device).manual_seed(SEED))
    run = lambda graphs=None: model.likelihood(x0, epsilon=eps, graphs=graphs)  # noqa: E731
    first_s, _ = walled(run)
    port.ops.reset_launch_counts()
    wall, (bpd, z, nfe) = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "edm_nll")
    steps = model.sampler.sample_steps - 1
    busy = replay_busy(graph, "i", 0, iters=3) * 1e3 * steps  # a step's replays traced, not the whole call's
    assert graph.delta == {k: 2 * v for k, v in per.items()}, (graph.delta, per)
    graph_line(f"edm likelihood B={EDM_LIK_B} NFE {int(nfe)} (first call with capture {first_s:.3f} s)", wall,
               busy / 1e3, None, graph, counts, steps)
    eager_s, eager = walled(lambda: run(False))
    kernels = model.sampler
    model.sampler = port.config.instantiate(model.cfg.sampler, device=device)  # its own graphs: the plain path's
    try:
        with plain_path(port):
            plain, _z, _n = model.likelihood(x0, epsilon=eps)
    finally:
        model.sampler = kernels
    rel = float(((bpd - plain).abs() / plain.abs()).max())
    log(f"[edm] likelihood B={EDM_LIK_B}: bits/dim kernels {float(bpd.mean()):.5f} plain {float(plain.mean()):.5f} "
        f"(max relative difference {rel:.3e}, tol {EDM_BPD_TOL}); captured eager max |diff| "
        f"{float((bpd - eager[0]).abs().max()):.3e}; NFE {int(nfe)}; captured {wall * 1e3:.3f} ms, busy {busy:.3f} ms, "
        f"eager {eager_s * 1e3:.3f} ms [{card}]")
    assert int(nfe) == 2 * steps and rel <= EDM_BPD_TOL and bool(torch.isfinite(z).all())


def check_encode(model, device, card, tag, nfe, pairs, grid=None, latent=""):
    """15d and 17d. ``encode`` of 64 images up the sampler's grid (NFE
    ``nfe``) and the chain back from the latents; ``interpolate`` of
    ``pairs`` pairs, on the sampler's grid or one of ``grid`` steps:
    captured == eager bit for bit (cudnn.deterministic), walls. ``tag``
    and ``latent`` (a note after the latent's std) go into the line."""
    import torch

    on = {} if grid is None else {"t": grid}
    x0 = family_bpd_batch(device, B)
    with deterministic():
        z, z_eager = model.encode(x0), model.encode(x0, graphs=False)
        x1, x2 = (x0[:pairs] + 1) / 2, (x0[pairs:2 * pairs] + 1) / 2
        mid, mid_eager = model.interpolate(x1, x2, **on), model.interpolate(x1, x2, graphs=False, **on)
    assert torch.equal(z, z_eager) and torch.equal(mid, mid_eager), "encode / interpolate: captured differs"
    walled(lambda: model.encode(x0))  # the capture
    enc_s, z = walled(lambda: model.encode(x0), n=2)
    with torch.inference_mode():
        back = model.sampler.p_sample_loop(model.get_model_fn(), model.params, tuple(x0.shape), img=z)
    rel = float(((back * 2 - 1) - x0).norm() / x0.norm())
    walled(lambda: model.interpolate(x1, x2, **on))  # the captures
    interp_s, mid = walled(lambda: model.interpolate(x1, x2, **on), n=2)
    log(f"[{tag}] encode B={B} NFE {nfe}: {enc_s * 1e3:.3f} ms captured, latent std {float(z.std()):.3f}{latent}; "
        f"decoded back: relative L2 to the data {rel:.3e} (random weights); interpolate {pairs} pairs on a grid of "
        f"{grid or model.sampler.sample_steps}: {interp_s * 1e3:.3f} ms captured [{card}]")
    assert bool(torch.isfinite(back).all()) and bool(torch.isfinite(mid).all()) and mid.shape == x1.shape


def check_edm_archive_and_serving(port, model, per, tmp):
    """15e. ``.dmn`` save and restore (the same weights, the same chain bit
    for bit), the swaps refused, and /sample served with the archive's own
    Heun-18 (seeded: equal to ``EDM.sample``), launches = one forward's x
    35 x batches."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor

    path = model.save_to(os.path.join(tmp, "EDM.dmn"))
    back = port.models.restore_model_from_archive(path, device=model.device)
    assert type(back) is type(model) and all(torch.equal(back.params[k], model.params[k]) for k in model.params)
    with deterministic():
        same = torch.equal(back.sample(8, 32, generator=svc_generator(back)),
                           model.sample(8, 32, generator=svc_generator(model)))
    assert same, "the restored EDM samples differently"
    try:
        serve(back, port=0)
        raise AssertionError("serve() swapped DDIM into an EDM archive")
    except ValueError as e:
        refusal = str(e)
    nfe = 2 * model.sampler.sample_steps - 1
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(back, port=0, max_batch=B, use_ddim_sampler=False, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    try:
        t1 = time.perf_counter()
        code, body = http("POST", f"http://{server.host}:{server.port}/sample",
                          {"num_images": 8, "seed": EDM_SERVE_SEED, "format": "npy"})
        req_s = time.perf_counter() - t1
        stats = json.loads(http("GET", f"http://{server.host}:{server.port}/stats")[1])
    finally:
        server.shutdown()
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    imgs = np.load(io.BytesIO(body))
    ref = to_uint8_tensor(back.sample(B, 32, generator=svc_generator(back, EDM_SERVE_SEED), use_ema=True))[:8]
    expect = {k: v * nfe * (stats["batches"] + 1) for k, v in per.items()}
    log(f"[edm] .dmn restored as {type(back).__name__} (same weights, same chain); serve() swaps refused "
        f"({refusal[:60]}...); /sample status {code} {list(imgs.shape)} in {req_s:.3f} s (warm-up {warm_s:.2f} s), "
        f"== EDM.sample {np.array_equal(imgs, ref.cpu().numpy())}; launches {json.dumps(counts)} = one forward's x "
        f"{nfe} x {stats['batches'] + 1} batches")
    assert code == 200 and imgs.shape == (8, 32, 32, 3) and np.array_equal(imgs, ref.cpu().numpy())
    assert counts == expect, (counts, expect)


def check_edm_clis(port, device, tmp):
    """15f. ``train_edm`` (3 steps at batch 8, a sample dump and bits/dim at
    step 3, the archive), ``eval_edm`` (batch 8, churn, the trajectory's
    GIF), ``test_edm`` (batch 8: the loss and the ODE bits/dim)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import eval_edm, test_edm, train_edm

    t0 = time.perf_counter()
    port.ops.reset_launch_counts()
    model, trainer = train_edm.main([
        *CLI_MODEL, "model.train_ds.name=synthetic", f"model.train_ds.batch_size={EDM_CLI_B}",
        f"trainer.max_steps={EDM_CLI_STEPS}", f"model.save_every={EDM_CLI_STEPS}", "model.compute_bpd=true",
        f"exp_manager.exp_dir={tmp}/exp", "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run",
        f"+model.results_dir={tmp}/results", *EDM_AUG])
    cli_counts(port, "train_edm", UNET_KERNELS)
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    train_s = time.perf_counter() - t0
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    t0 = time.perf_counter()
    out = eval_edm.main([f"model_path={dmn}", f"batch_size={EDM_CLI_B}", "s_churn=1.0", "show_diffusion=true",
                         f"output_dir={tmp}/samples", "add_timestamp=false"])
    eval_s = time.perf_counter() - t0
    assert (out / "diffusion.gif").is_file() and len(list(out.glob("sample_*.png"))) == EDM_CLI_B
    t0 = time.perf_counter()
    result = test_edm.main([f"model_path={dmn}", f"batch_size={EDM_CLI_B}", "limit_test_batches=1",
                            "dataset_name=synthetic"])
    test_s = time.perf_counter() - t0
    log(f"[edm] train_edm {EDM_CLI_STEPS} steps B={EDM_CLI_B} (augment_prob 0.12, aug_dim 9): {train_s:.2f} s, "
        f"logged {json.dumps(trainer.logged)}; eval_edm B={EDM_CLI_B} (churn, GIF): {eval_s:.2f} s; test_edm "
        f"B={EDM_CLI_B}: {json.dumps(result)} in {test_s:.2f} s")
    assert result["avg_num_forward_evaluations"] == 2 * (model.sampler.sample_steps - 1)
    assert np.isfinite(result["test_total_bpd"]) and np.isfinite(result["test_edm_loss"])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the EDM CLIs loaded {loaded}"


def check_conditional_edm(port, device, rows, card):
    """15g. ConditionalEDM (K = 10) served guided at two scales: the kernels
    at the guided 2B forward's shapes, seeded /sample per scale; the second
    scale replays the guided graphs (Heun steps and the last Euler step)
    that the first captured, and captures nothing."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.serving import serve

    model = edm_model(port, device, [f"model.num_classes={NUM_CLASSES}"])
    x, _t = model_inputs(device, 32)
    t = model.sampler.model_time(torch.full((B,), 2.0, device=device))
    labels = model._label_array(B, COND_LABEL)
    scale = torch.tensor(COND_SCALE, device=device)
    calls = {"conditional_edm_guided_2B": record_calls(
        port, None, None, None, run=lambda: model._cfg_forward(model.params, x, t, labels, scale))}
    assert per_forward_counts(calls["conditional_edm_guided_2B"]) == derived_counts(port, model, 2 * B, 32)
    hold_kernels(port, calls, rows)
    server = serve(model, port=0, max_batch=B, use_ddim_sampler=False, use_ema=True)
    server.start_background()

    def guided():
        return {id(g): g for k, g in model.sampler.graphs.items()
                if any(getattr(part, "__name__", "") == "_cfg_forward" for part in k)}

    outs, seen = {}, None
    try:
        for w in EDM_SCALES:
            replays = {i: g.info["replays"] for i, g in guided().items()}
            n_graphs = len(model.sampler.graphs)
            t0 = time.perf_counter()
            outs[w] = np.load(io.BytesIO(http("POST", f"http://{server.host}:{server.port}/sample", {
                "num_images": 4, "label": COND_LABEL, "guidance_scale": w, "seed": COND_SEED, "format": "npy"})[1]))
            wall = time.perf_counter() - t0
            used = {i: g for i, g in guided().items() if g.info["replays"] > replays.get(i, 0) or i not in replays}
            captured = [i for i in used if i not in replays]
            assert len(used) == 2, (w, len(used))  # the Heun steps' graph and the last Euler step's
            assert seen is None or (not captured and set(used) == seen and len(model.sampler.graphs) == n_graphs), \
                f"guidance scale {w} captured a graph of its own"
            seen = set(used)
            pool = sum(g.info["pool_mib"] for g in used.values())
            log(f"[edm] conditional /sample label {COND_LABEL} w={w} B={B} (2B = {2 * B} a network call, NFE "
                f"{2 * model.sampler.sample_steps - 1}): {wall:.3f} s, the guided graphs "
                f"{'captured here' if captured else 'replayed (captured at the first scale)'} (pool {pool:.1f} MiB); "
                f"graphs held {len(model.sampler.graphs)} [{card}]")
    finally:
        server.shutdown()
    assert len(guided()) == 2 and not np.array_equal(*outs.values())


def lapped(tag, fn, *args, prefix="edm"):
    """``fn(*args)``, its wall logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{prefix}] {tag} in {time.perf_counter() - t0:.1f} s")
    return out


def check_edm(port, device, rows):
    """15. The ConvNeXt U-Net and the EDM family on the card."""
    import torch

    t15 = time.perf_counter()
    card = card_line()  # written beside every [edm] time
    lapped("15a convnext", check_convnext, port, device, rows, card)
    model = edm_model(port, device)
    x, _t = model_inputs(device, 32)
    t = model.sampler.model_time(torch.full((B,), 2.0, device=device))  # σ = 2's float time
    calls = {"edm": record_calls(port, model, x, t)}
    per = per_forward_counts(calls["edm"])
    log(f"[edm] EDM (the ResNet unet_small, float times c_noise·250) launches a forward: {json.dumps(per)}")
    assert per == derived_counts(port, model, B, 32)
    hold_kernels(port, calls, rows)
    lapped("15b Heun-18", check_edm_chain, port, "Heun-18", model, per, card)
    base = dict(model.cfg.sampler)
    model.change_sampler(dict(base, **EDM_CHURN))
    noise = torch.randn((model.sampler.sample_steps, B, 32, 32, 3), device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED))
    lapped("15b Heun-18 churn", check_edm_chain, port, "Heun-18 churn 40 (injected noise)", model, per, card,
           noise)
    model.change_sampler(dict(base, solver="euler"))
    lapped("15b Euler-18", check_edm_chain, port, "Euler-18", model, per, card)
    model.change_sampler(base)
    aug = edm_model(port, device, EDM_AUG)
    lapped("15b augmented step", step_against_plain, port, "edm augment_prob 0.12 aug_dim 9", aug,
           derived_counts(port, aug, TRAIN_B, 32), card)
    lapped("15c likelihood", check_edm_likelihood, port, model, device, derived_counts(port, model, EDM_LIK_B, 32),
           card)
    lapped("15d encode, interpolate", check_encode, model, device, card, "edm", 2 * (model.sampler.sample_steps - 1),
           EDM_INTERP_B, None, f" (σ_max {model.sampler.sigma_max})")
    tmp = tempfile.mkdtemp(prefix="dmn_edm_")
    cwd = os.getcwd()
    try:
        lapped("15e archive, /sample", check_edm_archive_and_serving, port, model, per, tmp)
        os.chdir(tmp)
        lapped("15f CLIs", check_edm_clis, port, device, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    lapped("15g guided ConditionalEDM", check_conditional_edm, port, device, rows, card)
    log(f"[edm] phase 15 in {time.perf_counter() - t15:.1f} s")


SR3_YAML = "examples/configs/sr3/unet_small.yaml"
SR3_64_B = 16  # the 64-px forward and the cascade's batch
SR3_PREFIX = 50  # the ancestral chain's last steps held captured against eager
SR3_BPD_B, SR3_BPD_SHORT_T = 32, 50
SR3_CLI_B, SR3_CLI_STEPS = 8, 3
SR3_SEED = 11
SR3_COND_AUG = ["+model.cond_aug_std=0.1"]


def sr3_model(port, device, size=32, scale=4, overrides=()):
    """SR3 from examples/configs/sr3/unet_small.yaml (unet_small's network,
    bf16, dim 32, [1, 2, 4, 8], a 6-channel stem) at ``size`` px and
    ``scale``, random weights from ``SEED``."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / SR3_YAML, overrides=[
        f"model.image_size={size}", f"model.scale_factor={scale}", "model.train_ds.name=synthetic", *overrides]).model
    return port.models.SR3(cfg, device=device, seed=SEED)


def sr3_lr(model, B, seed=SEED):
    """An LR batch in [0, 1] at the model's LR size: seeded HR images,
    degraded as in training."""
    import torch

    size = int(model.image_size)
    g = torch.Generator(device=model.device).manual_seed(seed)
    hr = torch.rand((B, size, size, 3), generator=g, device=model.device) * 2.0 - 1.0
    with torch.inference_mode():
        return (model.degrade(hr) + 1.0) * 0.5


def sr3_forward_inputs(model, B):
    """(x_t, t, the condition) for one conditioned forward at batch ``B``."""
    import torch

    x, t = model_inputs(model.device, int(model.image_size), B)
    with torch.inference_mode():
        cond = model.upsample(sr3_lr(model, B) * 2.0 - 1.0)
    return x, t, cond


def sr3_forward(model, x, t, cond):
    return lambda: model.conditioned_forward(model.params, x, t, cond)


def check_sr3_kernels(port, device, rows, card, m32, m64, unet):
    """16a. #1-#4 at SR3's shapes: every call of the 32-px forward at B=64 and
    128 and of the 64-px forward at B=16 held against its plain version
    (device ms and bound logged); launches a forward equal the gates'; the
    forwards against the plain path; busy ms beside unet_small's."""
    import torch

    inputs = {"sr3_32": (m32, sr3_forward_inputs(m32, B)), "sr3_32_128": (m32, sr3_forward_inputs(m32, TRAIN_B)),
              "sr3_64": (m64, sr3_forward_inputs(m64, SR3_64_B))}
    calls = {name: record_calls(port, None, None, None, run=sr3_forward(m, *args)) for name, (m, args) in inputs.items()}
    per = {name: per_forward_counts(c) for name, c in calls.items()}
    gates = {name: derived_counts(port, m, args[0].shape[0], int(m.image_size)) for name, (m, args) in inputs.items()}
    log(f"[sr3] launches a forward: {json.dumps(per)}; the gates (meta forward): {json.dumps(gates)}")
    assert per == gates and per["sr3_32"] == per["sr3_32_128"] == per_forward_counts(
        record_calls(port, unet, *model_inputs(device, 32))), per
    hold_kernels(port, calls, rows, tag="sr3", timed=True)
    for name, (m, (x, t, cond)) in inputs.items():
        if name == "sr3_32_128":
            continue
        out_k = sr3_forward(m, x, t, cond)()
        with plain_path(port):
            out_p = sr3_forward(m, x, t, cond)()
        rel = float((out_k - out_p).norm() / out_p.norm())
        log(f"[sr3] {name} forward B={x.shape[0]} kernels vs plain: rel_l2 {rel:.3e} (tol {UNET_REL_TOL}), "
            f"shape {list(out_k.shape)}")
        assert rel <= UNET_REL_TOL and tuple(out_k.shape) == tuple(x.shape) and bool(torch.isfinite(out_k).all())
    x, t = model_inputs(device, 32)
    busy = {"unet_small B=64": device_profile(lambda: unet.forward(x, t), iters=5)[0],
            "sr3_32 B=64": device_profile(sr3_forward(m32, *inputs["sr3_32"][1]), iters=5)[0],
            "sr3_64 B=16": device_profile(sr3_forward(m64, *inputs["sr3_64"][1]), iters=5)[0]}
    walls = {"sr3_32 B=64": time_ms(sr3_forward(m32, *inputs["sr3_32"][1]), iters=10),
             "sr3_64 B=16": time_ms(sr3_forward(m64, *inputs["sr3_64"][1]), iters=10)}
    log(f"[sr3] forward device busy ms {json.dumps({k: round(v, 4) for k, v in busy.items()})} (the SR3 32-px "
        f"forward's extra: {busy['sr3_32 B=64'] - busy['unet_small B=64']:.4f} ms); wall ms "
        f"{json.dumps({k: round(v, 4) for k, v in walls.items()})} [{card}]")
    return per


def check_step_vs_plain(port, prefix, tag, model, per, card, cond_aug, timed=True):
    """16b and 17b. One B=128 step against the plain path (loss 1e-2,
    gradient 5e-2, no launch in the backward); one captured step against
    the eager step (cudnn.deterministic; bit for bit where eager repeats
    itself); the captured step's wall and busy. ``cond_aug``: whether the
    step draws SR3's condition augmentation; ``prefix`` tags the lines."""
    batch, draws = training_batch(model, TRAIN_B)
    assert ("cond_aug" in draws) == cond_aug, sorted(draws)
    loss_k, g_k, fwd, bwd, _m = step_loss_and_grads(port, model, batch, draws)
    assert_counts(f"{prefix} {tag} step forward", fwd, per)
    assert_counts(f"{prefix} {tag} step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _f, _b, _m = step_loss_and_grads(port, model, batch, draws)
    rel_loss, rel_grad = abs(loss_k - loss_p) / abs(loss_p), float((g_k - g_p).norm() / g_p.norm())
    with deterministic():
        ee, ee_diff, ge, ge_diff = state_spread(steps_run(port, model, [batch]))
    line = (f"[{prefix}] {tag} step B={TRAIN_B} draws {sorted(k for k in draws if not k.startswith('dropout/'))}: loss "
            f"kernels {loss_k:.6f} plain {loss_p:.6f} (rel {rel_loss:.3e}, tol {LOSS_REL_TOL}); gradient rel_l2 "
            f"{rel_grad:.3e} (tol {GRAD_REL_TOL}); eager twice bit-equal {ee} (max |diff| {ee_diff:.3e}), captured "
            f"vs eager bit-equal {ge} (max |diff| {ge_diff:.3e}) under cudnn.deterministic")
    if timed:
        trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
        state = trainer.init_state(model, TRAIN_STEPS)
        run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
        wall = time_ms(run, iters=20)
        busy, _ = device_profile(run, iters=2)
        graph = graph_of(state.graphs, "train_step")
        line += (f"; captured step {wall:.3f} ms wall, {busy:.3f} ms busy, {TRAIN_B / wall * 1e3:.1f} samples/s, "
                 f"graph launches {json.dumps(graph.delta)} [{card}]")
        assert graph.delta == per, (graph.delta, per)
    log(line)
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    assert ge if ee else ge_diff <= ee_diff, f"{prefix} {tag}: the captured step left the eager steps' bounds"


def sr3_prefix(model, lr, graphs, steps=SR3_PREFIX, seed=SEED):
    """The ancestral chain's last ``steps`` steps on ``lr``'s condition from
    a seeded x_T, through the sampler's graph owner (``graphs``)."""
    import torch

    s = model.scale_factor
    shape = (lr.shape[0], lr.shape[1] * s, lr.shape[2] * s, 3)
    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.inference_mode():
        fn = model.get_model_fn(cond=model.upsample(lr * 2.0 - 1.0))
        x_T = torch.randn(shape, generator=g, device=model.device)
        return model.sampler.p_sample_loop(fn, model.params, shape, g, img=x_T, num_steps=steps, graphs=graphs)


def two_batches_one_graph(tag, model, run):
    """``run(lr, graphs)`` for two LR batches, captured then eager (cudnn.
    deterministic): the second replays the graph the first captured, and
    each equals its own eager chain bit for bit."""
    import torch

    lrs = [sr3_lr(model, B, SEED + i) for i in (1, 2)]
    with deterministic():
        first = run(lrs[0], None)
        held = dict(model.sampler.graphs)
        second = run(lrs[1], None)
        same_graphs = held.keys() == model.sampler.graphs.keys() and all(
            model.sampler.graphs[k] is held[k] for k in held)
        eager = [run(lr, False) for lr in lrs]
    equal = torch.equal(first, eager[0]) and torch.equal(second, eager[1])
    log(f"[sr3] {tag} B={B}: two LR batches back to back replay one graph {same_graphs}; each == its eager chain "
        f"bit for bit {equal}; the two differ {not torch.equal(first, second)}")
    assert same_graphs and equal and not torch.equal(first, second), tag


def check_sr3_chains(port, model, per, card):
    """16c. The ancestral 1000-step super_resolve chain at B=64 (its last 50
    steps captured == eager for two LR batches through one graph; the whole
    chain timed), then DDIM-50 and DPM-20 after swaps (captured == eager
    for two LR batches through one graph, timed): wall, busy, launches."""
    import torch

    base = dict(model.cfg.sampler)
    T = model.sampler.timesteps
    two_batches_one_graph(f"ancestral last {SR3_PREFIX} steps", model, lambda lr, g: sr3_prefix(model, lr, g))
    lr = sr3_lr(model, B)
    run = lambda graphs=None: model.super_resolve(lr, generator=svc_generator(model), graphs=graphs)  # noqa: E731
    first_s, _ = walled(run)  # the capture
    port.ops.reset_launch_counts()
    wall, out = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "ancestral")
    busy = replay_busy(graph, "t", T - 1) * T
    assert bool(torch.isfinite(out).all()) and tuple(out.shape) == (B, 32, 32, 3)
    graph_line(f"sr3 ancestral super_resolve T={T} B={B} (first call with capture {first_s:.3f} s)", wall, busy,
               None, graph, counts, T - 1, extra=dict(graph.delta))
    log(f"[sr3] ancestral T={T} B={B}: {wall * 1e3:.3f} ms a chain ({B / wall:.2f} images/s), busy {busy * 1e3:.3f} "
        f"ms [{card}]")
    for name in ("ddim", "dpm"):
        svc_sampler(model, base, name)
        nfe = svc_nfe(model, name)
        two_batches_one_graph(f"{name} NFE {nfe}", model,
                              lambda lr, g: model.super_resolve(lr, generator=svc_generator(model), graphs=g))
        first_s, _ = walled(run)
        port.ops.reset_launch_counts()
        wall, _out = walled(run, n=3)
        counts = port.ops.launch_counts()
        graph = graph_of(model.sampler.graphs, SVC_GRAPH[name])
        busy, _ = device_profile(run, iters=1)
        assert graph.delta == per, (name, graph.delta, per)
        graph_line(f"sr3 {name} super_resolve B={B} NFE {nfe} (first call with capture {first_s:.3f} s)", wall,
                   busy / 1e3, None, graph, counts, 3 * nfe)
        log(f"[sr3] {name} B={B} NFE {nfe}: {wall * 1e3:.3f} ms a chain ({B / wall:.2f} images/s), busy "
            f"{busy:.3f} ms [{card}]")
    model.change_sampler(base)


def check_sr3_bpd(port, device, model, card):
    """16d. Conditional bits/dim at T = 1000 on a batch of 32 (the LR derived
    from the batch), captured, against the plain path captured on a sampler
    of its own (2e-2); at T = 50 the captured loop == eager bit for bit
    (cudnn.deterministic)."""
    import torch

    x0 = family_bpd_batch(device, SR3_BPD_B)
    T = model.sampler.timesteps
    run = lambda: model.calculate_bits_per_dimension(x0, generator=svc_generator(model))  # noqa: E731
    walled(run)  # the eager first step and the capture
    port.ops.reset_launch_counts()
    wall, kern = walled(run)
    counts = port.ops.launch_counts()
    graph = graph_of(model.sampler.graphs, "bpd")
    busy = replay_busy(graph, "t", T - 1, iters=10)
    graph_line(f"sr3 bpd T={T} B={SR3_BPD_B} (per step)", wall / T, busy, None, graph, counts, T)
    kernels = model.sampler
    model.sampler = port.config.instantiate(model.cfg.sampler, device=device)  # its own graphs: the plain path's
    try:
        with plain_path(port):
            plain_s, plain = walled(run)
    finally:
        model.sampler = kernels
    rel = float(((kern["total_bpd"] - plain["total_bpd"]).abs() / plain["total_bpd"].abs()).max())
    short = sr3_model(port, device, overrides=[f"model.timesteps={SR3_BPD_SHORT_T}"])
    with deterministic():
        a, b = (short.calculate_bits_per_dimension(x0, generator=svc_generator(short), graphs=g) for g in (None, False))
    same = all(torch.equal(a[k], b[k]) for k in a)
    log(f"[sr3] bits/dim T={T} B={SR3_BPD_B}: total_bpd kernels {float(kern['total_bpd'].mean()):.5f} plain "
        f"{float(plain['total_bpd'].mean()):.5f} (max relative difference {rel:.3e}, tol {BPD_REL_TOL['bfloat16']}); "
        f"captured {wall:.3f} s a batch, busy {busy * T:.3f} s, plain path {plain_s:.3f} s; T={SR3_BPD_SHORT_T} "
        f"captured == eager bit for bit {same} [{card}]")
    assert rel <= BPD_REL_TOL["bfloat16"] and same and bool(torch.isfinite(kern["terms_bpd"]).all())


def check_sr3_serving(port, model, unet, tmp, card):
    """16e. A SamplingServer on a restored SR3 archive (DDIM-50, max_batch
    64): /super_resolve with uint8 and float inputs (seeded: the same
    bytes twice and from either), two unseeded requests queued under
    ``hold()`` run as one batch, /sample answers 400, a generation archive
    answers /super_resolve 400; images/s over a window of phase 13's four
    concurrent clients (their requests coalesce into full batches)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import BatchingSampler, SamplingServer, serve

    back = port.models.restore_model_from_archive(model.save_to(os.path.join(tmp, "SR3.dmn")), device=model.device)
    assert type(back).__name__ == "SR3"
    t0 = time.perf_counter()
    server = serve(back, port=0, max_batch=B, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    url = f"http://{server.host}:{server.port}"
    lr = np.random.default_rng(SR3_SEED).integers(0, 256, (8, 8, 8, 3)).astype(np.uint8)

    def b64(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return base64.b64encode(buf.getvalue()).decode("ascii")

    def post(path, payload, base=None):
        try:
            code, body = http("POST", (base or url) + path, payload)
        except urllib.request.HTTPError as e:
            code, body = e.code, e.read()
        return code, body

    try:
        seeded = [post("/super_resolve", {"images_npy": b64(a), "seed": SR3_SEED, "format": "npy"})
                  for a in (lr, lr, lr.astype(np.float32) / 255.0)]
        outs = [np.load(io.BytesIO(body)) for _code, body in seeded]
        assert all(code == 200 for code, _ in seeded) and outs[0].shape == (8, 32, 32, 3)
        assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], outs[2]), "seeded /super_resolve moved"
        before = json.loads(http("GET", url + "/stats")[1])["batches"]
        got = []
        with server.batcher.hold():
            threads = [threading.Thread(target=lambda i=i: got.append(post(
                "/super_resolve", {"images_npy": b64(lr[i * 4: i * 4 + 4]), "format": "npy"}))) for i in (0, 1)]
            for th in threads:
                th.start()
            while server.batcher.queued() < 2:
                time.sleep(0.001)
        for th in threads:
            th.join(timeout=300)
        coalesced = json.loads(http("GET", url + "/stats")[1])["batches"] - before
        sample_code, sample_body = post("/sample", {"num_images": 1})
        answers, errors = [], []

        def client(n, deadline):
            try:
                while time.perf_counter() < deadline:
                    code, body = post("/super_resolve", {"images_npy": b64(np.resize(lr, (n, 8, 8, 3))),
                                                         "format": "npy"})
                    answers.append((code, n, np.load(io.BytesIO(body)).shape == (n, 32, 32, 3)))
            except Exception as e:  # reported below
                errors.append(repr(e))

        t1 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(n, t1 + SVC_WINDOW_S)) for n in SVC_CLIENT_SIZES]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=300)
        window = time.perf_counter() - t1
        stats = json.loads(http("GET", url + "/stats")[1])
    finally:
        server.shutdown()
    generation = SamplingServer(BatchingSampler(unet, 32, max_batch=B).start(warmup=False), port=0)
    generation.start_background()
    try:
        refused = post("/super_resolve", {"images_npy": b64(lr)}, f"http://{generation.host}:{generation.port}")[0]
    finally:
        generation.shutdown()
    images = sum(n for _, n, _ in answers)
    log(f"[sr3] /super_resolve from the restored archive (DDIM-50, max_batch {B}, warm-up {warm_s:.2f} s): uint8 "
        f"and float inputs 200, seeded the same bytes 3 times; two unseeded requests under hold() ran as "
        f"{coalesced} batch(es) ({[c for c, _ in got]}); /sample {sample_code} ({sample_body[:60]!r}); a DDPM "
        f"archive's /super_resolve {refused}; {len(SVC_CLIENT_SIZES)} clients {list(SVC_CLIENT_SIZES)} over "
        f"{window:.3f} s: {len(answers)} requests, {images} images, {images / window:.2f} images/s served, "
        f"{stats['batches']} batches (fill {stats['avg_batch_fill']}), latency {stats['avg_request_latency_ms']} ms "
        f"[{card}]")
    assert coalesced == 1 and all(c == 200 for c, _ in got) and sample_code == 400 and refused == 400
    assert not errors and answers and all(code == 200 and ok for code, _, ok in answers), errors


def check_sr3_cascade(port, device, up, tmp, card):
    """16f. The unet_small DDPM at 32 px (DDIM-50) into SR3 x2 at 64 px
    (ancestral, T = 1000) at B=16: the cascade == its stages run by hand
    with the stage generators, and ``from_archives`` == the objects, bit
    for bit (cudnn.deterministic); each stage's ms. Returns the archives."""
    import torch

    from diffusion_model_nemo_tpu_torch.pipelines import CascadePipeline, stage_generator

    base = port.DDPM(port.config.unet_small_model_config(), device=device, seed=SEED)
    use_sampler(base, DDIM, eta=0.0, ddim_timesteps=DDIM_STEPS)
    pipe = CascadePipeline(base, [up])
    with deterministic():
        t0 = time.perf_counter()
        stages = pipe.sample(SR3_64_B, seed=SEED, return_stages=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        base_s, x0 = walled(lambda: base.sample(SR3_64_B, 32, generator=stage_generator(SEED, 0, device)))
        up_s, x1 = walled(lambda: up.super_resolve(x0, generator=stage_generator(SEED, 1, device)))
        paths = [base.save_to(os.path.join(tmp, "base.dmn")), up.save_to(os.path.join(tmp, "sr3_64.dmn"))]
        restored = CascadePipeline.from_archives(paths[0], paths[1:], device=device)
        use_sampler(restored.base, DDIM, eta=0.0, ddim_timesteps=DDIM_STEPS)
        again = restored.sample(SR3_64_B, seed=SEED, return_stages=True)
    by_hand = torch.equal(stages[0], x0) and torch.equal(stages[1], x1)
    archived = all(torch.equal(a, b) for a, b in zip(stages, again))
    log(f"[sr3] cascade unet_small@32 (DDIM-{DDIM_STEPS}) -> SR3@64 (x2, ancestral T={up.sampler.timesteps}) "
        f"B={SR3_64_B}: == stages by hand {by_hand}, from_archives == objects {archived}; first call with captures "
        f"{first_s:.3f} s; base {base_s * 1e3:.3f} ms, upscaler {up_s * 1e3:.3f} ms (replays) [{card}]")
    assert by_hand and archived and tuple(stages[1].shape) == (SR3_64_B, 64, 64, 3)
    assert bool(torch.isfinite(stages[1]).all())
    return paths


def check_sr3_clis(port, device, tmp, archives):
    """16g. ``train_sr3`` (3 steps at batch 8 on a name: file npz written
    here, 32 px x4, a dump and bits/dim), ``eval_sr3`` from its archive and
    ``cascade_sr3`` from the cascade's archives at batch 8; a PNG folder
    with labels.npy through ``build_dataloader`` with ``resize_to``; none
    of PyYAML, msgpack, flax, orbax or Pillow imported."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import cascade_sr3, eval_sr3, train_sr3
    from diffusion_model_nemo_tpu_torch.data import build_dataloader
    from diffusion_model_nemo_tpu_torch.utils.image import encode_png

    rng = np.random.default_rng(SEED)
    np.savez(os.path.join(tmp, "hr.npz"), images=rng.integers(0, 256, (16, 32, 32, 3)).astype(np.uint8))
    t0 = time.perf_counter()
    port.ops.reset_launch_counts()
    model, trainer = train_sr3.main([
        "model.image_size=32", "model.scale_factor=4", "model.train_ds.name=file",
        f"+model.train_ds.path={tmp}/hr.npz", f"model.train_ds.batch_size={SR3_CLI_B}", "model.train_ds.num_workers=2",
        f"trainer.max_steps={SR3_CLI_STEPS}", f"model.save_every={SR3_CLI_STEPS}", f"exp_manager.exp_dir={tmp}/exp",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run", f"+model.results_dir={tmp}/results",
        *SR3_COND_AUG])
    cli_counts(port, "train_sr3", UNET_KERNELS)
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    train_s = time.perf_counter() - t0
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged) and os.listdir(f"{tmp}/results")
    t0 = time.perf_counter()
    out, psnr = eval_sr3.main([f"model_path={dmn}", f"input_path={tmp}/hr.npz", f"batch_size={SR3_CLI_B}",
                               f"output_dir={tmp}/sr", "add_timestamp=false"])
    eval_s = time.perf_counter() - t0
    assert len(list(out.glob("sr_*.png"))) == SR3_CLI_B and np.isfinite(psnr).all()
    t0 = time.perf_counter()
    out, stages = cascade_sr3.main([f"base_path={archives[0]}", f"upscaler_paths={archives[1]}",
                                    f"batch_size={SR3_CLI_B}", "use_ddim_sampler=true",
                                    f"output_dir={tmp}/cascade", "add_timestamp=false"])
    cascade_s = time.perf_counter() - t0
    assert len(list(out.glob("sample_*.png"))) == SR3_CLI_B and tuple(stages[-1].shape) == (SR3_CLI_B, 64, 64, 3)
    folder = os.path.join(tmp, "pngs")
    os.makedirs(folder)
    for i in range(12):
        with open(os.path.join(folder, f"{i:02d}.png"), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)))
    np.save(os.path.join(folder, "labels.npy"), np.arange(12) % 10)
    batch = next(iter(build_dataloader({"name": "file", "path": folder, "batch_size": SR3_CLI_B, "resize_to": 32,
                                        "num_workers": 2}, mode="train")))
    assert batch["image"].shape == (SR3_CLI_B, 32, 32, 3) and batch["label"].shape == (SR3_CLI_B,)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    log(f"[sr3] train_sr3 {SR3_CLI_STEPS} steps B={SR3_CLI_B} (npz file dataset, cond_aug_std 0.1, a dump and "
        f"bits/dim): {train_s:.2f} s, logged {json.dumps(trainer.logged)}; eval_sr3 B={SR3_CLI_B}: PSNR "
        f"{float(psnr.mean()):.3f} dB (random weights) in {eval_s:.2f} s; cascade_sr3 B={SR3_CLI_B} (32 -> 64 px): "
        f"{cascade_s:.2f} s; a PNG folder with labels.npy resized 40 -> 32 through build_dataloader: "
        f"{list(batch['image'].shape)}; modules not on the card loaded: {loaded}")
    assert not loaded, f"the SR3 path loaded {loaded}"


def check_sr3(port, device, rows, models):
    """16. SR3 super-resolution, the cascade, /super_resolve and the file
    datasets on the card."""
    t16 = time.perf_counter()
    card = card_line()  # written beside every [sr3] time
    m32 = sr3_model(port, device)
    m64 = sr3_model(port, device, size=64, scale=2)
    per = lapped("16a kernels", check_sr3_kernels, port, device, rows, card, m32, m64, models["unet_small"],
                 prefix="sr3")
    lapped("16b step", check_step_vs_plain, port, "sr3", "default", m32, per["sr3_32_128"], card,
           m32.cond_aug_std > 0, prefix="sr3")
    aug = sr3_model(port, device, overrides=SR3_COND_AUG)
    lapped("16b step with cond_aug_std", check_step_vs_plain, port, "sr3", "cond_aug_std 0.1", aug, per["sr3_32_128"],
           card, aug.cond_aug_std > 0, False, prefix="sr3")
    lapped("16c chains", check_sr3_chains, port, m32, per["sr3_32"], card, prefix="sr3")
    lapped("16d bits/dim", check_sr3_bpd, port, device, m32, card, prefix="sr3")
    tmp = tempfile.mkdtemp(prefix="dmn_sr3_")
    cwd = os.getcwd()
    try:
        lapped("16e /super_resolve", check_sr3_serving, port, m32, models["unet_small"], tmp, card, prefix="sr3")
        archives = lapped("16f cascade", check_sr3_cascade, port, device, m64, tmp, card, prefix="sr3")
        os.chdir(tmp)
        lapped("16g CLIs", check_sr3_clis, port, device, tmp, archives, prefix="sr3")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sr3] phase 16 in {time.perf_counter() - t16:.1f} s")


RF_YAML = "examples/configs/rectified_flow/unet_small.yaml"
# A unet_small forward at 32 px: #1 at its 35 GroupNorm + SiLU sites, #2 at
# four levels, #3 once, #4 at the bottleneck.
RF_PER = {"group_norm_silu": 35, "linear_attention_block": 4, "linear_attention_tokens": 1,
          "attention_block_small": 1}
RF_LIK_B = 32
RF_BPD_TOL = 2e-2  # bits/dim, kernels vs plain path, relative, bf16
RF_INTERP_B, RF_INTERP_STEPS = 16, 10  # interpolate's pairs and grid (encode's is the sampler's 50)
RF_PAIR_STEPS = 50  # the reflow step's teacher chain (the YAML's sample_steps)
RF_STEP_REPLAYS = 3  # captured reflow steps timed
RF_ROUND_STEPS, RF_ROUND_PAIR_STEPS = 2, 10  # steps a reflow round (two rounds), their teacher chain
RF_CLI_B, RF_CLI_STEPS, RF_CLI_PAIR_STEPS = 8, 2, 10


def rf_model(port, device, overrides=()):
    """RectifiedFlow from examples/configs/rectified_flow/unet_small.yaml at
    32 px, full width (dim 32, [1, 2, 4, 8], bf16, the ResNet U-Net), random
    weights from ``SEED``."""
    from diffusion_model_nemo_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / RF_YAML,
                      overrides=[*CLI_MODEL, "model.train_ds.name=synthetic", *overrides]).model
    return port.models.RectifiedFlow(cfg, device=device, seed=SEED)


def check_rf_kernels(port, device, rows, model):
    """17a. The launches of a B=64 forward at float path times (the gates'
    and 35/4/1/1), each #1-#4 call held against its plain version."""
    import torch

    x, _t = model_inputs(device, 32)
    t = model.sampler.model_time(torch.rand((B,), generator=svc_generator(model), device=device))
    calls = {"rectified_flow": record_calls(port, model, x, t)}
    per = per_forward_counts(calls["rectified_flow"])
    log(f"[rf] RectifiedFlow (the ResNet unet_small, float times t·1000) launches a forward: {json.dumps(per)}")
    assert per == derived_counts(port, model, B, 32) == RF_PER, per
    hold_kernels(port, calls, rows, tag="rf")
    return per


def check_rf_chain(port, model, per, card, solver):
    """17c. The sampler's chain at B=64 (EMA weights) with ``solver``, all
    under cudnn.deterministic: captured == eager bit for bit twice; the
    captured and eager walls, device busy, NFE; launches = the graphs'
    counts x replays (Heun: two forwards a step, the last Euler step a
    graph of its own)."""
    import torch

    model.change_sampler(dict(model.cfg.sampler, solver=solver))
    s = model.sampler
    M, heun = s.sample_steps, solver == "heun"
    nfe = 2 * M - 1 if heun else M
    run = lambda graphs=None: model.sample(B, 32, generator=svc_generator(model), use_ema=True,  # noqa: E731
                                           graphs=graphs)
    with deterministic():
        eager_s, ref = walled(lambda: run(False))
        first_s, first = walled(run)  # the capture
        port.ops.reset_launch_counts()
        wall, again = walled(run, n=2)
        counts = port.ops.launch_counts()
        busy, _ = device_profile(run, iters=1)
    assert torch.equal(ref, first) and torch.equal(ref, again), f"{solver}-{M}: captured differs from eager"
    assert bool(torch.isfinite(ref).all()) and float(ref.std()) > 0, solver
    graph = graph_of(s.graphs, "rf_down_heun" if heun else "rf_down_euler")
    steps = M - 1 if heun else M
    assert graph.delta == {k: v * (2 if heun else 1) for k, v in per.items()}, (solver, graph.delta, per)
    graph_line(f"rf {solver}-{M} B={B} NFE {nfe} (first call with capture {first_s:.3f} s; == eager bit for bit; "
               f"all under cudnn.deterministic)", wall, busy / 1e3, eager_s, graph, counts, 2 * steps,
               {k: 2 * v for k, v in per.items()} if heun else None)
    log(f"[rf] {solver}-{M} B={B}: NFE {nfe}, captured {wall * 1e3:.3f} ms a chain ({B / wall:.1f} images/s), "
        f"device busy {busy:.3f} ms ({busy / nfe:.3f} ms a network call, {100 * busy / (wall * 1e3):.1f}% of the "
        f"wall), eager {eager_s * 1e3:.3f} ms [{card}]")


def check_rf_likelihood(port, model, device, per, card):
    """17e. The exact NLL at B=32 (Euler on the 50 transitions, NFE 50), all
    under cudnn.deterministic: captured == eager bit for bit; the captured
    step (forward and εᵀJε backward) replayed, launches = one forward a
    step and nothing in the backward, wall and busy; against the plain path
    (captured on a sampler of its own, so that no graph of one path replays
    for the other)."""
    import torch

    x0 = family_bpd_batch(device, RF_LIK_B)
    eps = model.sampler.draw_epsilon(x0.shape, torch.Generator(device=device).manual_seed(SEED))
    run = lambda graphs=None: model.likelihood(x0, epsilon=eps, graphs=graphs)  # noqa: E731
    steps = model.sampler.sample_steps
    with deterministic():
        eager_s, eager = walled(lambda: run(False))
        first_s, captured = walled(run)
        port.ops.reset_launch_counts()
        wall, (bpd, z, nfe) = walled(run)
        counts = port.ops.launch_counts()
        graph = graph_of(model.sampler.graphs, "rf_nll")
        busy = replay_busy(graph, "i", 0, iters=3) * 1e3 * steps  # a step's replays traced, not the whole call's
    assert all(torch.equal(a, b) for a, b in zip(eager, captured)), "likelihood: captured differs from eager"
    assert graph.delta == per, (graph.delta, per)
    graph_line(f"rf likelihood B={RF_LIK_B} NFE {int(nfe)} (first call with capture {first_s:.3f} s; == eager bit "
               f"for bit; all under cudnn.deterministic)", wall, busy / 1e3, eager_s, graph, counts, steps)
    kernels = model.sampler
    model.sampler = port.config.instantiate(model.cfg.sampler, device=device)  # its own graphs: the plain path's
    try:
        with plain_path(port):
            plain, _z, _n = model.likelihood(x0, epsilon=eps)
    finally:
        model.sampler = kernels
    rel = float(((bpd - plain).abs() / plain.abs()).max())
    log(f"[rf] likelihood B={RF_LIK_B}: bits/dim kernels {float(bpd.mean()):.5f} plain {float(plain.mean()):.5f} "
        f"(max relative difference {rel:.3e}, tol {RF_BPD_TOL}); NFE {int(nfe)}; captured {wall * 1e3:.3f} ms, busy "
        f"{busy:.3f} ms, eager {eager_s * 1e3:.3f} ms [{card}]")
    assert int(nfe) == steps and rel <= RF_BPD_TOL and bool(torch.isfinite(z).all())


def reflow_draws(model, n, seed=SEED):
    """``n`` steps' (z, time draw) at B=64, seeded."""
    import torch

    g = svc_generator(model, seed)
    return [(torch.randn((B, 32, 32, 3), generator=g, device=model.device), model.sampler.draw_times(B, g))
            for _ in range(n)]


def check_rf_reflow_step(port, model, per, card):
    """17f. The fused reflow step at B=64, pair_steps 50 (lr 1e-4, clip 1),
    all under cudnn.deterministic: two steps from the teacher, eager and
    captured (the first step the capture's eager warm-up, the second a
    replay): the students and losses bit for bit; the graph launches one
    forward's x 51 (the teacher's 50, the student's one; nothing in the
    backward); then replays timed: wall, busy, the graph's nodes and
    pool."""
    import torch

    draws = reflow_draws(model, 2)

    def run(graphs):
        trainer = port.training.ReflowTrainer(model, pair_steps=RF_PAIR_STEPS)
        state = trainer.init_state(model.params)
        losses = torch.stack([trainer.train_step(state, z, u, graphs=graphs) for z, u in draws])
        torch.cuda.synchronize()
        return trainer, state, losses

    def diff(a, b):
        return max(float((a[1].student[k] - b[1].student[k]).abs().max()) for k in a[1].student)

    with deterministic():
        t0 = time.perf_counter()
        eager = run(False)
        eager_s = (time.perf_counter() - t0) / len(draws)
        captured = run(None)
        max_diff = diff(captured, eager)  # before the replays below move the captured student on
        equal = max_diff == 0 and torch.equal(captured[2], eager[2])
        trainer, state, _ = captured
        z, u = draws[0]
        step = lambda: trainer.train_step(state, z, u)  # noqa: E731
        port.ops.reset_launch_counts()
        wall, loss = walled(step, n=RF_STEP_REPLAYS)
        counts = port.ops.launch_counts()
        busy, _ = device_profile(step, iters=1)
    graph = graph_of(trainer.graphs, "reflow_step")
    assert graph.delta == {k: v * (RF_PAIR_STEPS + 1) for k, v in per.items()}, (graph.delta, per)
    graph_line(f"rf reflow step B={B} pair_steps {RF_PAIR_STEPS} (the teacher's chain, the student's forward and "
               f"backward, clip, AdamW; cudnn.deterministic)", wall, busy / 1e3, eager_s, graph, counts,
               RF_STEP_REPLAYS)
    log(f"[rf] reflow step B={B} pair_steps {RF_PAIR_STEPS}: losses eager {eager[2].tolist()} captured "
        f"{captured[2].tolist()}, students and losses bit-equal {equal} (max |diff| {max_diff:.3e}) under "
        f"cudnn.deterministic; captured {wall * 1e3:.3f} ms a step, busy {busy:.3f} ms, eager {eager_s * 1e3:.3f} ms; "
        f"capture {graph.info['capture_s']:.3f} s, {graph.info['nodes']} nodes, pool {graph.info['pool_mib']:.1f} "
        f"MiB; loss {float(loss):.6f} [{card}]")
    assert equal, "reflow: the captured step differs from the eager step"
    assert bool(torch.isfinite(captured[2]).all())


def check_rf_rounds_and_serving(port, model, per, tmp, card):
    """17g. Two reflow rounds of two steps: round 1's teacher is the model's
    weights, round 2's is round 1's student, and round 2's graph is captured
    on it (round 1's is gone); ``student_model(sample_steps=1)``, its .dmn
    restored (the same weights, one step), the sampler swaps refused, /edit
    refused (400), /sample served over a window of four clients: images/s,
    fill, launches = one forward's x batches."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.serving import serve

    trainer = port.training.ReflowTrainer(model, pair_steps=RF_ROUND_PAIR_STEPS)
    teachers, states, graphs = [], [], []
    init = trainer.init_state

    def init_state(teacher):
        graphs.append(list(trainer.graphs.values()))
        teachers.append(teacher)
        states.append(init(teacher))
        return states[-1]

    trainer.init_state = init_state
    t0 = time.perf_counter()
    params, losses = trainer.reflow(RF_ROUND_STEPS, B, generator=svc_generator(model), rounds=2, log_every=1)
    rounds_s = time.perf_counter() - t0
    (graph,) = trainer.graphs.values()
    assert teachers[0] is model.params and len(states) == 2
    assert all(teachers[1][k].data_ptr() == states[0].student[k].data_ptr() for k in model.params)
    assert all(graph is not g for g in graphs[1]) and graph.info["replays"] == RF_ROUND_STEPS - 1
    assert all(any(s is t for s in graph.sources) for t in teachers[1].values()), "round 2's graph reads another teacher"
    assert all(torch.equal(params[k], states[1].student[k]) for k in params)
    student = trainer.student_model(params, sample_steps=1)
    path = student.save_to(os.path.join(tmp, "RF1.dmn"))
    back = port.models.restore_model_from_archive(path, use_ema=True, device=model.device)
    assert type(back).__name__ == "RectifiedFlow" and back.sampler.sample_steps == 1
    assert all(torch.equal(back.params[k], params[k]) for k in params)
    try:
        serve(back, port=0)
        raise AssertionError("serve() swapped DDIM into a flow archive")
    except ValueError as e:
        refusal = str(e)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(back, port=0, max_batch=B, use_ddim_sampler=False, use_ema=True)
    warm_s = time.perf_counter() - t0
    server.start_background()
    url = f"http://{server.host}:{server.port}"
    buf = io.BytesIO()
    np.save(buf, np.zeros((1, 32, 32, 3), np.uint8))
    try:
        try:
            code, body = http("POST", url + "/edit", {"images_npy": base64.b64encode(buf.getvalue()).decode()})
        except urllib.request.HTTPError as e:
            code, body = e.code, e.read()
        assert code == 400 and b"no edit surface" in body, (code, body)
        answers, wall, stats, images = client_window(server, "rf one-step")
    finally:
        server.shutdown()
    counts = {k: v for k, v in port.ops.launch_counts().items() if v}
    batches = stats["batches"] + 1
    log(f"[rf] two reflow rounds x {RF_ROUND_STEPS} steps B={B} pair_steps {RF_ROUND_PAIR_STEPS}: {rounds_s:.2f} s, losses "
        f"{[round(v, 6) for v in losses]}; round 2 captured anew on round 1's student; student_model(sample_steps=1) "
        f"restored from .dmn; swaps refused ({refusal[:50]}...); /edit {code}; /sample of the one-step student, "
        f"warm-up {warm_s:.2f} s, {len(SVC_CLIENT_SIZES)} clients over {wall:.3f} s: {len(answers)} requests, "
        f"{images} images in {stats['batches']} batches (fill {stats['avg_batch_fill']}), {images / wall:.2f} "
        f"images/s served, latency {stats['avg_request_latency_ms']} ms, avg device ms a batch "
        f"{stats['avg_device_ms_per_batch']}; launches {json.dumps(counts)} = one forward's x {batches} batches "
        f"[{card}]")
    assert np.isfinite(losses).all() and counts == {k: v * batches for k, v in per.items()}, (counts, per)


def check_rf_clis(port, tmp):
    """17h. ``train_rectified_flow`` (2 steps at batch 8, a sample dump at
    step 2, the archive), ``eval_rectified_flow`` (Heun-10, batch 8, the
    GIF), ``test_rectified_flow`` (batch 8: the loss, the exact bits/dim,
    NFE 50), ``reflow_rectified_flow`` (2 steps at batch 8, pair steps 10,
    the one-step archive); ``devices=2`` refused."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.cli import (eval_rectified_flow, reflow_rectified_flow, test_rectified_flow,
                                                    train_rectified_flow)

    t0 = time.perf_counter()
    port.ops.reset_launch_counts()
    model, trainer = train_rectified_flow.main([
        *CLI_MODEL, "model.train_ds.name=synthetic", f"model.train_ds.batch_size={RF_CLI_B}",
        f"trainer.max_steps={RF_CLI_STEPS}", f"model.save_every={RF_CLI_STEPS}", f"exp_manager.exp_dir={tmp}/exp",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run", f"+model.results_dir={tmp}/results"])
    cli_counts(port, "train_rectified_flow", UNET_KERNELS)
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    train_s = time.perf_counter() - t0
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    assert (Path(tmp) / "results" / "sample-1-1.png").is_file()
    t0 = time.perf_counter()
    out = eval_rectified_flow.main([f"model_path={dmn}", f"batch_size={RF_CLI_B}", "solver=heun", "num_steps=10",
                                    "show_diffusion=true", f"output_dir={tmp}/samples", "add_timestamp=false"])
    eval_s = time.perf_counter() - t0
    assert (out / "diffusion.gif").is_file() and len(list(out.glob("sample_*.png"))) == RF_CLI_B
    t0 = time.perf_counter()
    result = test_rectified_flow.main([f"model_path={dmn}", f"batch_size={RF_CLI_B}", "limit_test_batches=1",
                                       "dataset_name=synthetic"])
    test_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    student, losses = reflow_rectified_flow.main([
        f"model_path={dmn}", f"output_path={tmp}/RF_reflowed.dmn", f"steps={RF_CLI_STEPS}",
        f"batch_size={RF_CLI_B}", f"pair_steps={RF_CLI_PAIR_STEPS}", "log_every=1"])
    reflow_s = time.perf_counter() - t0
    try:
        reflow_rectified_flow.main([f"model_path={dmn}", "devices=2"])
        raise AssertionError("reflow_rectified_flow ran on devices=2")
    except NotImplementedError:
        pass
    log(f"[rf] train_rectified_flow {RF_CLI_STEPS} steps B={RF_CLI_B}: {train_s:.2f} s, logged "
        f"{json.dumps(trainer.logged)}; eval_rectified_flow Heun-10 B={RF_CLI_B} (GIF): {eval_s:.2f} s; "
        f"test_rectified_flow B={RF_CLI_B}: {json.dumps(result)} in {test_s:.2f} s; reflow_rectified_flow "
        f"{RF_CLI_STEPS} steps B={RF_CLI_B} pair_steps {RF_CLI_PAIR_STEPS}: losses {losses} in {reflow_s:.2f} s; "
        f"devices=2 refused")
    assert result["avg_num_forward_evaluations"] == model.sampler.sample_steps
    assert np.isfinite(result["test_total_bpd"]) and np.isfinite(result["test_fm_loss"])
    assert student.sampler.sample_steps == 1 and np.isfinite(losses).all()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not loaded, f"the flow CLIs loaded {loaded}"


def check_rectified_flow(port, device, rows):
    """17. Rectified flow and reflow on the card."""
    t17 = time.perf_counter()
    card = card_line()  # written beside every [rf] time
    model = rf_model(port, device)
    per = lapped("17a kernels", check_rf_kernels, port, device, rows, model, prefix="rf")
    lapped("17b step", check_step_vs_plain, port, "rf", "rectified flow", model,
           derived_counts(port, model, TRAIN_B, 32), card, False, prefix="rf")
    lapped("17c Euler-50", check_rf_chain, port, model, per, card, "euler", prefix="rf")
    lapped("17c Heun-50", check_rf_chain, port, model, per, card, "heun", prefix="rf")
    model.change_sampler(dict(model.cfg.sampler, solver="euler"))
    lapped("17d encode, interpolate", check_encode, model, device, card, "rf", model.sampler.sample_steps,
           RF_INTERP_B, RF_INTERP_STEPS, prefix="rf")
    lapped("17e likelihood", check_rf_likelihood, port, model, device, derived_counts(port, model, RF_LIK_B, 32),
           card, prefix="rf")
    lapped("17f reflow step", check_rf_reflow_step, port, model, per, card, prefix="rf")
    tmp = tempfile.mkdtemp(prefix="dmn_rf_")
    cwd = os.getcwd()
    try:
        lapped("17g rounds, /sample", check_rf_rounds_and_serving, port, model, per, tmp, card, prefix="rf")
        os.chdir(tmp)
        lapped("17h CLIs", check_rf_clis, port, tmp, prefix="rf")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[rf] phase 17 in {time.perf_counter() - t17:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.ops import _build

    banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffusion_model_nemo_tpu"))
    assert not banned, f"the port loaded {banned}"
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.load_kernels()
    log(f"[build] {len(libs)} kernel libraries ({len(kernel_table(port))} kernels) built and loaded "
        f"in {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds['total']:.2f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[setup] TF32 off for convolutions and matmuls (cudnn.allow_tf32 = matmul.allow_tf32 = False)")

    from diffusion_model_nemo_tpu_torch.tools.profiling import tracing

    mark = {"t": time.perf_counter(), "traces": 0, "seconds": 0.0}

    def phase_done(tag):
        """The wall since the last phase, and the torch.profiler traces in it."""
        now = time.perf_counter()
        log(f"[time] {tag} in {now - mark['t']:.1f} s: {tracing['traces'] - mark['traces']} profiler traces, "
            f"{tracing['seconds'] - mark['seconds']:.1f} s in them (the next opens with {tracing['markers']} markers)")
        mark.update(t=now, traces=tracing["traces"], seconds=tracing["seconds"])

    models = build_models(port, device)
    inputs = {name: model_inputs(device, DIT_IMG if name == "dit_s2" else 32) for name in models}
    calls = {name: record_calls(port, m, *inputs[name]) for name, m in models.items()}
    # The training slice's shapes at B=128: the default routes (#1-#4), both
    # switches (#6, #9), and the FiLM Block pass at unet_small's GroupNorm
    # sites (#5, and #6 FiLM under NORM_BM).
    inputs128 = {name: model_inputs(device, 32, TRAIN_B) for name in ("unet_small", "flagship")}
    calls["unet_small_128"] = record_calls(port, models["unet_small"], *inputs128["unet_small"])
    new = ("group_norm_silu_bm", "linear_attention_block_v1")
    with switches(BOTH):
        for name in ("unet_small", "flagship"):
            rec = record_calls(port, models[name], *inputs128[name])
            calls[f"{name}_128_switched"] = {k: (v if k in new else {}) for k, v in rec.items()}
    sites = [key for key, (count, _a) in sorted(calls["unet_small_128"]["group_norm_silu"].items())
             for _ in range(count)]
    film = FilmPath(port, sites, device)
    calls["film_block"] = record_calls(port, None, None, None, run=film.forward)
    with switches(NORM_BM):
        rec = record_calls(port, None, None, None, run=film.forward)
    calls["film_block_bm"] = {k: (v if k == "group_norm_silu_bm" else {}) for k, v in rec.items()}
    per_forward = {name: per_forward_counts(c) for name, c in calls.items()}
    log(f"[path] launches per forward (B={B}; *_128*: B={TRAIN_B}; film_block: per pass): {per_forward}")
    assert per_forward["dit_s2"] == {"attention": 12}, per_forward["dit_s2"]
    rows = check_kernels(port, {**calls, **derived_calls(calls), **extra_calls(device)})
    check_networks(port, models, inputs)
    f32_counts = check_float32_route(
        port, models["unet_small_f32"], *inputs["unet_small_f32"], per_forward["unet_small_f32"]
    )
    counts = check_serving(port, "unet_small", models["unet_small"], per_forward["unet_small"], B, 32)
    dit_counts = check_serving(
        port, "dit_s2", models["dit_s2"], per_forward["dit_s2"], DIT_MAX_BATCH, DIT_IMG
    )
    check_ancestral(port, models["unet_small"], per_forward["unet_small"])
    phase_done("phases 2-5")

    # 6. The training slice.
    derived = check_switched_forwards(port, models, inputs128)
    film_counts = check_film_path(port, film)
    train_per = per_forward["unet_small_128"]
    batch, draws = check_training_step(port, models["unet_small"], train_per)
    training_kernel_costs(port, models["unet_small"], batch, draws)
    step_profile(port, models["unet_small"])
    check_fit(port, device, TRAIN_STEPS, {}, train_per)
    with switches(BOTH):
        switched_per = derived_counts(port, models["unet_small"], TRAIN_B, 32)
    log(f"[train] per forward under both switches at B={TRAIN_B} (gates): {switched_per}; "
        f"each switch alone: {json.dumps({'+'.join(k): v for k, v in derived.items()})}")
    assert switched_per.get("group_norm_silu_bm") == 27 and switched_per.get("linear_attention_block_v1") == 1
    assert "linear_attention_tokens" not in switched_per, switched_per
    _m, _t, sw_counts = check_fit(port, device, SWITCHED_STEPS, BOTH, switched_per)
    phase_done("phase 6")

    # 7. The tools path (#10-#13).
    tool_rows, tool_counts, per_forward["tools"], v1_err = check_tools(port)
    rows.update(tool_rows)
    rows["linear_attention_block_v1"]["max_abs_err"] = max(rows["linear_attention_block_v1"]["max_abs_err"], v1_err)
    check_tap_split_backward(port, device)
    phase_done("phase 7")

    # 8. The README's usage path: the CLIs in a temporary directory.
    t8 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dmn_cli_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        check_cli_path(port, device, per_forward["unet_small"], tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[cli] phase 8 in {time.perf_counter() - t8:.1f} s")
    phase_done("phase 8")

    # 9. CUDA graphs: every loop's replays against its eager loop.
    check_graphs(port, models, device, train_per)
    phase_done("phase 9")

    # 10. The two families, the DiT with classes, their CLIs.
    check_families(port, device)
    phase_done("phase 10")

    # 11. ScoreSDE: kernels at 4 GroupNorm groups, the PC and probability-flow
    # samplers, serving, training, the likelihood, the other SDEs, the CLIs.
    check_score_sde(port, device, rows)
    phase_done("phase 11")

    # 12. The WaveGrad family: WavegradDDPM and the vocoder.
    check_wavegrad(port, device, rows)
    phase_done("phase 12")

    # 13. The sampling services: DPM-Solver++, UniPC, Karras, frames,
    # interpolation, SDEdit (/edit), RePaint, their CLIs.
    check_sampling_services(port, models, device)
    phase_done("phase 13")

    # 14. The training options and the Trainer's services: Min-SNR-γ,
    # offset noise, dropout, pred_v, zero terminal SNR, accumulation,
    # post-hoc EMA, profile_dir, the prefetcher, one guided graph.
    check_training_options(port, device)
    phase_done("phase 14")

    # 15. The ConvNeXt U-Net and the EDM family: chains, training, the
    # likelihood, encode / interpolate, the archive, /sample, the CLIs, the
    # guided ConditionalEDM.
    check_edm(port, device, rows)
    phase_done("phase 15")

    # 16. SR3: the kernels at its shapes (64 px among them), the step, the
    # chains, bits/dim, /super_resolve, the cascade, the CLIs and the file
    # datasets.
    check_sr3(port, device, rows, models)
    phase_done("phase 16")

    # 17. Rectified flow and reflow: the step, Euler and Heun chains,
    # encode / interpolate, the exact likelihood, the fused reflow step, two
    # rounds, the one-step student served, the CLIs.
    check_rectified_flow(port, device, rows)
    phase_done("phase 17")

    # Launches from each kernel's main-path run: unet_small serving for #1-#4,
    # DiT-S/2 serving for #7, the float32 DDIM-10 chain for #8, the FiLM
    # Block pass for #5, the 5-step training run under both switches for #6
    # and #9, the tools' run for #10-#13.
    main_counts = dict(counts, attention=dit_counts["attention"],
                       linear_attention_qkv=f32_counts["linear_attention_qkv"],
                       group_norm_silu_film=film_counts["group_norm_silu_film"],
                       group_norm_silu_bm=sw_counts["group_norm_silu_bm"],
                       linear_attention_block_v1=sw_counts["linear_attention_block_v1"],
                       **{name: tool_counts[name] for name in TOOL_KERNELS})
    main_per = {name: per_forward[MAIN_CFG[name]].get(name, 0) for name in rows}
    table = kernel_table(port)
    log(f"[summary] per forward on each kernel's main path (per pass over the tool shapes for "
        f"#10-#13; ms: CUDA events; dev: torch.profiler device time); main path: {MAIN_CFG}")
    log("[summary] | kernel | launches/forward on its path (flagship) | launches in the path's run "
        "| ms | dev ms | bound ms (by) | plain ms | plain dev ms | library ms | library dev ms |")
    for name, r in rows.items():
        by = "bytes" if r["bytes_s"] >= r["ops_s"] else "operations"
        lib_ms = "—" if r["library_ms"] is None else fmt(r["library_ms"])
        lib_dev = "—" if r["library_ms"] is None else fmt(r["library_dev"])
        flag = per_forward["flagship_128_switched" if name in new else "flagship"].get(name, 0)
        log(f"[summary] | {name} | {main_per[name]} ({flag}) | "
            f"{main_counts[name]} | {fmt(r['ms'])} | {fmt(r['dev'])} | "
            f"{fmt(r['bound_ms'], 5)} ({by}) | {fmt(r['plain_ms'])} | {fmt(r['plain_dev'])} | "
            f"{lib_ms} | {lib_dev} |")
    kernels = []
    for name, r in rows.items():
        _mod, _attr, _plain, src, rep = table[name]
        assert main_counts[name] > 0, (name, main_counts)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_s"] >= r["ops_s"] else "operations",
            "library_ms": r["library_ms"],
        })
    log(f"[profile] {tracing['traces']} torch.profiler traces ({tracing['retakes']} taken again) in "
        f"{tracing['seconds']:.1f} s, {tracing['seconds'] / max(tracing['traces'], 1) * 1e3:.2f} ms a trace; the most "
        f"markers a trace dropped "
        f"{tracing['dropped_max']} (each trace opens with twice what the last one dropped, at least 8)")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card_line())  # as nvidia-smi gives it, on its own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
