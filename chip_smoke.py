"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one CUDA
card and nvcc; it exits non-zero without them, and without the package
`ltx2_tpu_torch` beside it. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the three kernel libraries from csrc/ with nvcc (flash
   forward, flash backward, conv3d), one process per source, started
   together; ptxas's registers and spill for each kernel; the flash forward
   (both head dims), the bf16 conv kernel (three N tiles) and the fp32 conv
   kernel (3xTF32), each stride-1 and strided, must show 0 bytes of spill, no C7512 (wgmma serialised)
   warning and HGMMA (wgmma) in their SASS;
3. kernel check: the flash forward against `flash_attention_plain` on the
   card in bf16, at the DiT's self-attention (1, 32, 6144, 128), its text
   cross-attention (6144 queries x 1024 keys), a ragged key-masked case,
   head dim 64 (1, 32, 2048, 64), the two-stage recipe's stage-1
   self-attention (1, 32, 1536, 128), the one-stage CFG pipeline's two
   guidance rows, self (2, 32, 4290, 128) and cross (4290 queries x 1024
   keys), and the one-stage loop options' shapes: a 512-token bucket's
   self-attention at the STG rows' batch 3 (3, 32, 4608, 128, the first
   4290 keys valid in every row: two key tiles wholly masked, one partly)
   and at batch 2 over 4352 tokens (only the last tile partly valid), the
   STG rows' cross-attention (3, 32, 4608 x 1024), and the audio-video
   DiT's head-dim-64 attentions: the 126 audio tokens' self-attention, their
   text cross-attention (1024 keys, with and without a key mask), audio ->
   video (6144 and 1536 queries x 126 keys) and video -> audio (126 queries
   x 6144 and 1536 keys), and the two-stage CFG pipeline's stage-1 shapes
   at batch 3 (the multi-modal guider's cond, uncond and modality rows):
   video self (1536 tokens) and text (1024 keys) at head dim 128, audio
   self (126), audio text, audio -> video and video -> audio at 64, keyframe
   interpolation's lengths past the tile grid (stage 1's two rows over 1536
   + 2 x 96 appended tokens, self and text; stage 2's 6144 + 2 x 384) and
   ti2vid-hq's stage-1 rows at batch 2, within limits
   relative to the plain output that two planted faults must fail (and on
   a masked case a third: the kernel run with its mask dropped); with the
   valid keys the bound counts, the wrapper's and the kernel's own device
   time, plain, bound and scaled_dot_product_attention times (with a
   boolean key mask where the case has one);
4. conv kernel check: the implicit-GEMM convs against `conv3d_plain` at
   the serving paths' shapes (the decoder's stages S4 and S3, its conv_out
   on a decode tile, and on a two-stage decode tile a stage-1 res conv and
   the stage-2 upsample conv, on a one-stage decode tile (15 latent rows) a
   stage-1 res conv and conv_out, in bf16 with reflect/replicate padding; a
   causal case with ragged H and W; in fp32 with zero padding the spatial
   upscaler's five conv shapes: 1024 -> 1024 at both resolutions, the
   per-frame 1024 -> 4096 resampler, the initial 128 -> 1024 and the final
   1024 -> 128; with causal zero/replicate padding the video encoder's
   conv_in 48 -> 128, a 512 res conv, conv_out 1024 -> 129 through the
   module's padding to 136 outputs, and a split-K 1024 res conv, and on a
   whole 512x768x121 clip (retake's source, ic-lora's control) a 128 res
   conv over 121 x 128 x 192 and a 512 one over 61 x 64 x 96 (their float64
   check on the first 16 output frames, which a causal conv computes from
   the first 16 input frames alone); with zero
   padding the temporal upscaler's five conv shapes on a 512x768x121
   latent: 128 -> 512, 512 -> 512 before and after the shuffle (16 and 31
   frames), the upsampler's 512 -> 1024 and the final 512 -> 128; the full
   video VAE's strided causal convs at 17x256x384, compress_space (1, 2,
   2), compress_time (2, 1, 1) and compress_all (2, 2, 2), in fp32 and
   bf16, and a ragged one (17 x 63 x 95 at (2, 2, 2)), cuDNN at the same
   strides on the padded input), within
   relative limits that two planted faults (a tap left
   out, the output x 1.03) must fail; the fp32 kernel also within fp32
   accuracy of the plain version in float64, a limit single-pass TF32 must
   fail, and bitwise equal over two runs; with kernel (also its own device
   time), plain, bound (fp32: 3xTF32 and FFMA) and cuDNN (F.conv3d) times;
   a shape the kernel does not take must raise. Then the fp32 cases' times
   x their launches in a clip against the conv time of one traced upscaler
   call, within 10 %;
5. serving path: `generate_videos` at full width and depth (48 layers, the
   DiT's weights kept in fp8 as scripts/bench_e2e.py keeps them: E4M3 codes
   with a per-tensor scale, dequantized at use, about 12.9 GB; bf16
   compute, 512x768x121f = 6144 tokens, 8 distilled steps, VAE decode in
   7-frame chunks) for 2 requests of different seeds; checks the frames, the
   latents, the DiT's bytes and that every attention call went through the
   forward kernel (none through a backward kernel) and every decoder conv
   through the conv kernel; then one traced step of the loop with the fp8
   weights beside the same weights in bf16 (profile_slice.denoise_step);
5b. int8 W8A8: the bf16 DiT quantized in place on the card
   (`quantize_params_int8`; seconds, peak, weight GB), its x0 at 6144 tokens
   against the bf16 DiT's on the same weights (correlation above 0.999, as
   the JAX package asks), the same traced step beside the fp8 and bf16 ones,
   `torch._int_mm` bit for bit its plain int32 route at the DiT's shapes
   (with its time beside the bf16 product's) and a 16-row product refused,
   a 2-block checkpoint streamed with `quantize_int8` equal bit for bit to
   the file quantized on the card, and bench-e2e's loop on the int8 DiT (768
   flash and 3840 int8 products a clip); then the V2 step;
5c. the temporal upscaler at full width on a 512x768x121 latent: 31 frames,
   the card against the CPU (1e-5 rms, 1e-4 max relative), 19 fp32 conv
   launches, the call's time and peak; then `generate.main --pipeline
   one-stage --upscale-temporal` at 2 blocks, 128x128x17: a .y4m of 33
   frames;
6. text encode: the full-width fp32 Gemma-3-12B (48 layers, 3840 wide) and
   the V1 text encoder (feature extractor over 49 states, 2-block 30 x 128
   connector) built on the card, one request's 2 x 1024 prompt tokens
   encoded twice (the second call timed), with init seconds, peak memory,
   finiteness, the FLOP and bounds of an encode (3xTF32 and FFMA, as for
   the fp32 conv), and no kernel launch (the encode is plain torch ops, as
   the JAX package runs it outside Pallas); then the prompt enhancement's
   decode on the same Gemma: greedy, 32 tokens after a 256-token prompt,
   prefill seconds and the ms a token against the bound of reading every
   weight once a token, the last 4 picks' logits against an uncached
   gemma3_apply plus the LM head (max 1e-4, rms 1e-5 relative), no kernel
   launch; then a 2-layer, full-width Gemma (sliding then full, window 16) and the
   V1 encoder at 2 x 64 tokens on the card against the same weights on the
   CPU, within relative rms 1e-5 and max 1e-4; then the 48-layer Gemma
   quantized in memory to fp8 as `load_gemma3_params(quantize_fp8=True)`
   quantizes it, the encode timed with its weights and peak memory, and the
   2-layer check again with Gemma in fp8, at the same limits;
7. checkpoint phase: into a fresh temporary directory (its free space
   checked first, the files deleted at the end) the port's writers put a
   full-width, full-depth V1 video DiT in the reference `-fp8` layout with
   the VAE decoder, its statistics, the V1 text projection and video
   connector (about 14 GB), the spatial upscaler (v1.1 names), a 2-layer
   full-width bf16 Gemma-3 in two shards and a rank-16 LoRA; the DiT is
   loaded through `ModelLedger` kept in fp8, dequantized, and dequantized
   with the LoRA fused (seconds, GB read, GB/s, peak memory each); the kept
   codes and scales must equal the file's bit for bit, three fused weights
   the CPU's bf16(f32(bf16(f32(code) * scale)) + strength * B A) bit for
   bit, and one x0 forward at 6144 tokens of the kept model the dequantized
   one within 1e-2 of max|x0|; then 2 requests of the two-stage recipe from
   the files (`--fp8-serving`, the files' Gemma, `--text-encoder`): frames,
   finite contexts and latents, 1056 flash and 19 + 270 conv launches a clip;
7b. LTX-2.3 (V2) from files: the port's writers put a full-width,
   full-depth V2 video DiT in the `-fp8` layout (cross-attention AdaLN,
   gated attention, prompt AdaLN) with the VAE decoder, the V2 text
   projection and both gated connectors (8 blocks, 32 x 128 and 32 x 64),
   the upscaler, a 2-layer full-width Gemma and a tokenizer.json the script
   builds (a small BPE with byte fallback, a Replace normalizer, a <bos>
   template, one added token) into a temporary directory; then
   `generate.main --pipeline distilled --checkpoint ... --gemma-dir ...
   --spatial-upscaler ... --fp8-serving --prompt ... --output clip.y4m
   --requests 2`: the prompt ids equal the tokenizer's on the CPU, 1056
   flash, 19 fp32 and 270 bf16 conv launches a clip, finite contexts and
   latents, two .y4m files of the header plus 121 x (6 + 3 H W) bytes,
   each phase's seconds and peaks, each component's load seconds and the
   host tokenizer's seconds; then the same prompt through `--pipeline
   one-stage` and `text-to-video` (480x704x97, 2 steps); then, on the same
   files, the resident server (`python -m ltx2_tpu_torch.serve`'s `main`,
   `--pipeline distilled --fp8-serving`, 512x768x121, .y4m out) on a
   requests file: three prompts and seeds (one at num_frames 57), an
   unknown field (bad_request, the server up) and a 512x768x121 request
   for a .mp4 (no ffmpeg on the card's machine: the MJPEG .mp4, the GIF
   preview and the frames npz as its artifacts; the npz frames bit for bit
   the clip's, the .mp4's samples the port's JPEGs of them, its first
   frames through `read_mov_mjpeg`, its 121 frames probed; its save
   seconds), one
   setup and no load seconds in any request, each request's 1056 flash, 19
   fp32 and 270 bf16 conv launches (57 frames: its own tile count), the
   first clip byte for byte the command line's of the same request; the
   HTTP front on 127.0.0.1 port 0 (/healthz, one POST /generate, 411
   without a Content-Length); a second launch with --enhance-prompt (the
   2-layer Gemma decodes 512 tokens; the enhanced prompt is what the
   tokenizer encodes); setup seconds, resident GB, each request's seconds
   and peak; phase 5's traced step also runs for the V2 DiT in bf16 beside
   the V1 one;
8. two-stage path: `generate_videos_distilled(text_encoder=True)` (each
   request's prompts encoded by the full-width Gemma and V1 encoder, which
   are then released; the DiT with its caption projection; stage 1 at
   256x384, the fp32 spatial upscaler, stage 2 at 512x768 on the 3-sigma
   tail, tiled VAE decode) at full width and depth for 2 requests; checks
   the frames, finite contexts and latents after each stage, 1056 flash
   launches a clip, the conv launches the code implies (19 in the
   upscaler, 45 per decoder call and tile) and two distinct clips, with
   each phase's seconds and peak memory; then the same recipe at a small
   size (2-layer DiT, 128x128x17, tiled decode, dummy context) through the
   kernels against the same pipeline with every flash and conv call on its
   plain version, then the same with 2 full-width V2 blocks;
8b. audio-video: (a) the published audio decoder, LTX-2's vocoder and an
   LTX-2.3-shaped BWE chain on the card against the CPU (relative rms 1e-5,
   TF32 off, no kernel launch); (b) the AV two-stage recipe at a small size
   (2 full-width AV blocks, 128x128x17, 18 audio tokens) through the kernels
   against its plain versions (latents, audio latent and frames at the
   small check's limits, another seed rejected); (c) the AV two-stage
   recipe at full width (the random V1 AV DiT, AV_TWO_STAGE_LAYERS = 24
   blocks, cut from 48 for the script's time, 32 x
   128 video and 32 x 64 audio heads, kept in fp8; 512x768x121 and 126
   audio tokens; 2 requests through `generate_videos_distilled(audio=True)`,
   each written as a .y4m with a 24 kHz .wav of 120240 samples): each
   phase's seconds and peaks (the audio decode beside the video decode),
   6 flash launches an AV block a step (4 at head dim 64, 2 at 128), then
   one traced AV step at 6144 tokens beside phase 5's video-only fp8 step
   (48 blocks; the record names both depths),
   one at stage 1's 1536 tokens, audio-to-video on the same DiT
   (`generate_videos_a2vid`: a 16-bit stereo .wav written at 44.1 kHz, the
   published audio encoder with random weights written to a file and read
   through `ModelLedger.audio_encoder`; 2 requests, each a .y4m and a
   16 kHz .wav of the loader's samples; the audio latent bit for bit frozen
   after each stage; 6 flash launches an AV block a step and 19 + 270 convs
   a clip), and one traced audio decode; before (c), the two-stage CFG
   pipeline and a2vid at the small size of (b) through the kernels against
   their plain versions (two-stage with a rank-8 LoRA; its guided latents
   held to 5x the rms limit); (e) after (d), the two-stage CFG pipeline at
   full width, depth cut to 12 blocks (the random V1 AV DiT in bf16,
   512x768x121, 2 requests: stage 1 at 256x384 over 8 steps, cut from 30,
   under CFG 3.0, audio CFG 7.0, modality 3.0 and rescale 0.7, three rows
   at batch 3; a random rank-384 distilled LoRA on every block linear
   written to a file, fused for stage 2 and unfused; the tiled decode and
   the audio decode): each phase's seconds and peaks, 792 flash launches
   a clip (528 at head dim 64, 576 at batch 3) and 19 + 270 convs, the
   .y4m and 24 kHz .wav, and after the first request's unfuse every fused
   weight within one bf16 rounding step of its original (drawn again from
   the DiT's seed);
   then one traced
   3-row stage-1 step beside the 1-row AV step at 1536 tokens; (d) 2-layer full-width AV files for V1 and
   for V2 (`vocoder.bwe` metadata), each with the published audio decoder
   and its vocoder: the V1 file through `ModelLedger(include_audio=True,
   keep_fp8=True)` (the kept fp8 codes bit for bit), and `generate.main
   --pipeline distilled --checkpoint <V2 file> --fp8-serving --audio` to a
   .y4m and a 48 kHz .wav of 240480 samples;
9. image-to-video: first the committed stills on the host (`phase_stills`:
   each decoded by `read_image` to the SHA-256 of PIL's decode recorded in
   tests/fixtures_video/media_io.json, or refused with PIL's mode, the PNGs
   also through the video readers' still route; host ms a megapixel); the
   full-size phases (a)-(c) take the committed 512x768 progressive JPEG,
   the small checks an 8-bit PNG (1000 x 600, every row filter) written
   from a seed; (a) the full-width fp32 video encoder (published plan) on a
   256x384 and a 512x768 frame: seconds, the 3xTF32 bound, peak memory, 46
   fp32 conv launches an encode, and the 256x384 frame against the CPU
   within 1e-5 rms and 1e-4 max relative; (b) the two-stage recipe with
   the image at frame 0 (strength 0.95), 512x768x121, 48 layers: each
   phase's seconds and peaks, 1056 flash, 2 x 46 + 19 fp32 and 270 bf16
   conv launches; (c) the one-stage CFG* pipeline at the JAX defaults
   (480x704x97, cfg 3.0, rescale 0.7; steps cut from 30 to 10) with the
   image: 960 flash launches, 46 fp32 and the tiled decode's bf16 conv launches; then the
   same pipeline at a small size (2-layer DiT, small encoder plan,
   128x128x17, 3 steps, tiled decode) through the kernels against itself
   with every flash and conv call on its plain version; (d) at 2
   blocks and 128x128x9, strength 1.0 keeps frame 0 of the final latent
   the encoder's bit for bit, and a planted strength 0.9 run must fail the
   check; (e) `generate.main --pipeline text-to-video` on the card at
   128x128x33 with five `--image` conditions: the PNG and the committed
   16-bit PNG, LZW TIFF, BMP and RLE TGA, 5 x 46 + 45 conv launches;
   (f) the one-stage loop options at full width and depth (48 blocks,
   480x704x97, steps cut from 30 to 5) through `generate_videos_one_stage`:
   request A, the one-stage pipeline with the image, CFG* with STG on block
   29 (three rows), Heun, GE 0.5, the cross-attention scale 0.5 from block
   40, cached text K/V and a 512-token bucket (4290 -> 4608 tokens: the
   flash kernel's key-valid route); request B, text-to-video with APG and
   guidance reuse every second step; each request's seconds, peaks, frames
   and its flash, key-valid and conv launches against the counts the code
   implies; then A, B and the stateful APG with momentum at the small size
   of (c) (A with a 64-token bucket over 48 tokens), through the kernels
   against their plain versions, another seed rejected; (g) keyframe
   interpolation and ti2vid-hq at full width and depth on shared random
   modules, 512x768x121: keyframes at frames 0 (strength 1.0, its appended
   tokens bit for bit clean at each stage's end) and 120, stage 1 cut from
   30 steps to 4, stage 2 at 3, flash launches by length; ti2vid-hq with
   the image, the Res2s stage 1 cut from 15 steps to 4 (two evaluations a
   step at batch 2), then with audio at 2 AV blocks (flash at head dim 64);
   (h) the video readers and the flows that read a video: media I/O on the
   host against the hashes recorded in tests/fixtures_video/media_io.json
   with PIL, OpenCV and the JAX writers (the port's JPEGs of the committed
   AVI's 9 frames, its .avi, .mp4 and .mov of them with and without a
   stereo track, the committed GIF's and APNG's frames, the Canny signal of
   the AVI's frames at 256x384), with host ms per 512x768 frame of the JPEG
   encoder and decoder, the GIF writer and reader, the APNG reader and the
   Canny; the committed
   MJPEG AVI (tests/fixtures_video, 9 frames at 288x432, written by the
   JAX package's PIL writer) decoded by the port's JPEG decoder to the
   SHA-256 of PIL's decode recorded beside it, and through
   `read_avi_mjpeg` at 256x384x121 to the JAX reader's; the committed
   512x768 JPEG still likewise; host seconds a frame of the JPEG decoder
   and of `read_y4m` on a 512x768x121 .y4m the script writes; `generate.main
   --pipeline retake` on that source at full width and depth (window 1.0-3.0
   s, CFG 3.0, 4 steps cut from 30): the encode of the whole clip, denoise
   and decode seconds and peaks, flash at batch 2, and every latent token
   outside the window bit for bit the encoder's; `generate.main --pipeline
   ic-lora` with the AVI as the RAW control and a random rank-64 IC-LoRA on
   the attention and feed-forward linears of the 48 blocks (written to a
   file): fuse, control encode, stage 1 over 1536 + 1536 appended tokens,
   unfuse, upscale, stage 2, decode, every fused weight within one bf16
   rounding step of its draw after the unfuse; at 2 blocks the control at
   strength 1.0 bit for bit its clean latent at stage 1's end; the same
   flow with `--control-type canny --canny-low 20 --canny-high 60
   --save-control` (the port's Canny on the AVI read by the port's readers:
   the signal and its `.control.avi` against the recorded cv2 and JAX
   writer hashes, the launches the RAW run's); the 2-block AV distilled flow
   to an .avi and a .mov at 256x384x25, the PCM track read back bit for bit
   the written int16 samples; then
   `prepare_data --videos` on the AVI and a short .y4m, `--images` on the
   JPEG still, and one `train.main --data` step on the npz;
9b. the full video VAE at full width on a 17x256x384 clip, random weights
   from the port's init: the default encoder (fp32), the strided
   vocabulary (each compress_*_res a strided compress_* conv and a
   res_x_y; group norm; fp32; 4 strided launches), a dims=(2, 1)
   UNetMidBlock3D of DualConv3d with injected noise on its 512-wide stage,
   the default decoder in bf16 with timestep conditioning and decode
   noise; each through the kernels and with every conv on its plain
   version (latents within 1e-2 relative rms, frames within 2 levels on
   average, planted faults rejected), its first call's seconds, peak GB
   and launches; then the WebP reader on the host: the committed WebP
   fixtures (a lossy still, a lossless still with alpha, a lossy animation
   with alpha, a lossless animation) to the SHA-256 of PIL's frames in
   media_io.json, their probes, host ms a frame;
10. backward check: at the video DiT's training shapes (head dim 128:
   self, cross, masked ragged) and the audio-video DiT's (head dim 64: the
   126 audio tokens' self-attention, audio -> video 6144 x 126, video ->
   audio 126 x 6144, the audio text cross-attention 126 x 1024 with 700
   valid keys, and 6144² as a dense yardstick), the forward's residuals l,
   m against `flash_attention_residuals_plain`, and dq, dk, dv from the
   fused backward kernel against `flash_attention_bwd_plain` and against
   autograd of `flash_attention_plain` in fp32, within relative limits that
   planted faults (dq x 1.03, a 64-key tile left out of dk and dv) must
   fail; with the kernel's own device time, the whole backward's (Di,
   accumulator, kernel, dQ conversion), the five-product bound, the plain
   version's and SDPA's backward (and the names of the kernels SDPA ran);
11. training path: (a) `ltx2_tpu_torch.train.main` for 3 LoRA steps of the
   full-width 48-block DiT at 6144 tokens, checking finite losses, non-zero
   lora_B after step 1, a bit-identical base and the launch counts; (b) the
   step's time, TF/s and peak memory at scripts/bench_train.py's shape (1024
   text tokens); (c) adapter gradients of 2 full-width blocks through the
   kernels against the same model on plain attention; then, from a --data
   npz the script writes (6144 video tokens with a 1024-token context, 126
   audio tokens with their own 1024-token context, 700 keys valid): (d)
   `train.main --audio` for 3 rank-16 LoRA steps of the AV DiT at
   AV_TRAIN_LAYERS = 24 blocks (cut from 48 for the script's time) in
   bf16 and again on its fp8 frozen base (`--fp8-serving`), each with
   finite losses, every lora_B (the audio stream's 432 too) non-zero after
   step 1, every base linear bit for bit its seeded draw, 288 forward
   launches a step (192 at head dim 64) and 144 backward (96 at 64), its
   training state written and read back bit for bit (bytes, seconds), and
   the step timed at this shape (ms, TF/s, peak) beside (b); (e) a
   video-only dataset on the AV DiT (4 blocks, `--trainable to_q`, weight
   decay 0.1): the audio branch frozen, every audio-branch weight bit for
   bit its draw, only the video streams' q projections moved; (f) exact
   resume (4 AV blocks, 4 steps saved every 2, resumed from step 2): the
   file's adapters bit for bit, the first resumed loss bit for bit, the
   final adapters within 1 % rms of what the last two steps moved them; (g)
   adapter gradients of 2 full-width AV blocks through the kernels against
   plain attention; (h) the audio-only DiT (48 blocks, 126 audio tokens):
   2 flash launches a block at head dim 64, x0 with both modalities passed
   denoises the audio, and 2 blocks against the CPU in fp32; (i)
   `prepare_data` on 2 random 512x768x9 clips through the full-width
   encoder (46 fp32 conv launches a clip), its npz fed to one
   `train.main --data` step; (j) data-parallel training (`phase_train_dp`):
   world 1's runs, then 2 ranks on the card over gloo (`spawn_ranks`; over
   nccl too with a card per rank) through `train.main --dp-devices 2` for 3
   steps of attn1's projections in 8 full-width blocks at 6144 tokens:
   plain DP and --zero1 at batch 2, --zero2 --accum-steps 2 at batch 4,
   then LoRA on the fp8 base with --zero2 --save for 2 steps; every rank's
   parameters identical after each step, ZeRO-1's optimizer on plain DP's
   recorded gradients bit for bit plain DP (K3's dQ order varies run to
   run, so two runs read different gradient bits), the losses within 0.5 %
   of world 1's, ZeRO-1 half of plain DP's moment
   bytes and ZeRO-2 half of world 1's gradient bytes a rank, each rank's
   K1 and K3 launches as reckoned, only rank 0 writing the file; each
   rank's peak memory, collective bytes by route and step seconds logged;
   (k) Megatron-TP training (`phase_train_tp`): world 1's runs, then TP-2
   on 2 ranks and TP-2 x DP-2 on 4 over gloo on the card (nccl too with a
   card per rank) through `train.main --tp-devices 2 [--dp-devices 2]`
   for 2 steps at batch 2 of attn1's projections and Q/K norms in 4
   full-width blocks: TP-2, --zero2, and LoRA on the fp8 base with --zero1
   --save; losses within 0.5 % of world 1's, the replicated leaves bit for
   bit along 'model' and the slices along 'data' after each step, the
   moment bytes the layout rule gives, K1 and K3 launches as reckoned at 16
   of the 32 heads, only rank 0 writing a file of world 1's names and
   shapes; each rank's step seconds, peak and bytes by operation, route and
   axis logged.

The line before the kernels' record gives the whole script's seconds. The
second-to-last line of output is the kernels' JSON record (with the
bench-e2e, fp8 step, text encode, checkpoint, image-to-video, two-stage and
training records beside the kernels), the last the device record.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import shutil
import subprocess
import sys
import time

# The kernel rounds P and O to bf16, so its error scales with the output,
# whose size falls as 1/sqrt(keys) (randn q, k, v, scale d^-0.5: RMS about
# sqrt(e / keys), 0.021 at 6144 keys). Both limits are therefore relative to
# the plain output. Each case also plants two faults that must be rejected: a
# 64-key tile dropped from the softmax and the output off by 3 %.
TOL_MAX_REL = 2e-2  # max|kernel - plain| / max|plain|
TOL_RMS_REL = 1e-2  # rms(kernel - plain) / rms(plain)
# The backward kernels round P and dS to bf16 as product operands and write
# bf16 gradients; limits relative to the fp32 reference, as above.
TOL_BWD_MAX_REL = 2e-2
TOL_BWD_RMS_REL = 1e-2
# l and m are fp32 sums and maxima that differ from the plain version only
# in summation order (measured at most 1.1e-6 relative).
TOL_RES_REL = 1e-4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
# The conv kernels and their plain version sum in fp32 and round once; the
# bf16 kernel differs from the plain version in summation order only, which
# in bf16 can move an output by one rounding step (2^-8 relative); the fp32
# kernel's 3xTF32 products carry about 22 bits of each operand. Limits
# relative to the plain output: (max|err| / max|plain|, rms(err) /
# rms(plain)). Planted faults (a tap left out, the output x 1.03) must fail
# them.
CONV_TOL = {"bfloat16": (1e-2, 5e-3), "float32": (1e-4, 1e-4)}
# The fp32 kernel is also held to fp32 accuracy against the plain version
# in float64 on the same inputs: (max, rms) relative, a few times the fp32
# plain version's own error at the upscaler's K and 150x below single-pass
# TF32's, which is planted (x and w rounded to TF32, the plain version in
# fp32) and must fail.
CONV_TOL_F64 = (1e-5, 2e-6)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 (data sheet); 3xTF32 runs three products
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FRAMES, HEIGHT, WIDTH, STEPS, LAYERS = 121, 512, 768, 8, 48
SEEDS = (1, 2)
LAUNCHES_PER_CLIP = 2 * LAYERS * STEPS  # self + text cross-attention in every block and step
# The two-stage recipe: 8 distilled steps at half resolution, then 3 at full.
TWO_STAGE_LAUNCHES_PER_CLIP = 2 * LAYERS * (8 + 3)
# The two-stage recipe at a small size, kernels against plain versions on
# the card: the kernels' bf16 rounding (attention P and O, one rounding step
# per conv) carried through 11 DiT steps, the upscaler and the decoder
# (measured: latents rms 0.20-0.23 %, frames 0.46 levels on average).
TOL_SMALL_LATENT_RMS_REL = 1e-2
TOL_SMALL_MEAN_LEVELS = 2.0
TRAIN_STEPS = 3
# bench-e2e's DiT kept in fp8: 12.9 G E4M3 weights plus the fp32 AdaLN and
# tables (25.8 GB in bf16).
FP8_DIT_GB = (12.0, 14.0)
# Two encodes of the same tokens on the card (fp32, TF32 off): the same
# kernels in the same order, so at most summation-order noise.
TOL_ENCODE_REPEAT_MAX_REL = 1e-4
# Adapter gradients of 2 full-width blocks, kernels against plain attention:
# both runs share every other op, so the difference is the kernels' bf16 P,
# dS and output rounding carried through two blocks.
TOL_GRAD_MAX_REL = 2e-2
TOL_GRAD_RMS_REL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from ltx2_tpu_torch.ops._build import KERNEL_FUNCTIONS, build_kernels, kernel

    t0 = time.perf_counter()
    info = build_kernels()  # one nvcc per source, started together
    wall = time.perf_counter() - t0
    if set(info) != {"fwd", "bwd", "conv3d"}:
        raise AssertionError(f"built libraries {sorted(info)}")
    for fn in KERNEL_FUNCTIONS:
        kernel(fn)
    for name, rec in info.items():
        log(f"build {name}: {rec['path'].name} in {rec['seconds']:.1f} s")
        for ln in rec["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln or "C75" in ln:
                log(f"  ptxas: {ln.strip()}")
    log(f"build: wall {wall:.1f} s")
    _check_wgmma_build(info["fwd"], "flash_fwd_kernel", 2)  # head dims 64 and 128
    _check_wgmma_build(info["conv3d"], "conv3d_wgmma_kernel", 6)  # N tiles 48, 128, 256, each stride-1 and strided
    _check_wgmma_build(info["conv3d"], "conv3d_tf32x3_kernel", 2)  # stride-1 and strided
    return wall


def _check_wgmma_build(rec, kernel_name: str, instances: int) -> None:
    """Every instantiation of a wgmma kernel spills nothing, ptxas did not
    serialise its products (warning C7512), and its SASS runs them on wgmma
    (HGMMA). A log from a cached build is empty: the ptxas checks then rest
    on the build that made it."""
    from ltx2_tpu_torch.ops._build import cuda_tool

    entry, spills = None, {}
    for ln in rec["log"].splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill stores" in ln and entry is not None and kernel_name in entry:
            spills[entry] = ln.strip()
    if rec["log"] and (len(spills) != instances or any(
            not v.startswith("0 bytes stack frame, 0 bytes spill stores") for v in spills.values())):
        raise AssertionError(f"{kernel_name}: ptxas spill lines {spills}")
    serialised = [ln.strip() for ln in rec["log"].splitlines() if "C7512" in ln]
    if serialised:
        raise AssertionError(f"{kernel_name}: ptxas serialised wgmma: {serialised}")
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(rec["path"])], capture_output=True, text=True,
                          check=True).stdout
    fn, hgmma = None, {}
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
        elif "HGMMA" in ln and fn is not None:
            hgmma[fn] = hgmma.get(fn, 0) + 1
    wgmma = {k: v for k, v in hgmma.items() if kernel_name in k}
    log(f"{kernel_name} SASS: HGMMA instructions per kernel {wgmma}; ptxas {list(spills.values())}")
    if len(wgmma) != instances:
        raise AssertionError(f"{kernel_name}: HGMMA missing from its SASS ({hgmma})")


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> dict:
    """{kernel name: (device ms per call, launches per call)} of `iters`
    calls of fn, from one torch.profiler pass after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (dev_us / 1e3 / iters, e.count / iters)
    return out


def _events_and_host_ms(fn, iters: int) -> tuple:
    """(device ms per call between CUDA events, host ms per call to enqueue
    it) over `iters` calls of fn after a warm-up call. Where the host's
    time reaches the events', the events time the host, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def _kernel_ms(fn, kernel_name: str, iters: int, events_fn=None) -> tuple:
    """(device ms per call of the kernels named `kernel_name`, how it was
    timed, the profile by kernel, CUDA events' ms per call) over `iters`
    calls of fn. The kernel is timed both ways: by CUDA events around
    `events_fn` (default fn), which must launch little but the kernel, and
    by the profiler. A profiler reading over twice the events time, or
    under half of it where the events time the card and not the host (the
    host's enqueue time under half the events'), is refused: a partial
    capture once read the backward at 0.656 ms against 3.670 ms by events.
    Up to three profiler passes are taken; if none agrees with the events,
    the phase fails. The profiler may record no device event at all (CUPTI
    is shared with whatever else traces the card): after three passes
    without the kernel the time is the events'. That the kernel launched is
    the callers' check (their wrappers' launch counts and outputs), not the
    profile's."""
    events_ms, host_ms = _events_and_host_ms(events_fn or fn, iters)
    card_bound = host_ms < 0.5 * events_ms
    refused = []
    for _ in range(3):
        by_kernel = _device_ms(fn, iters)
        ms = sum(ms_ for n, (ms_, _) in by_kernel.items() if kernel_name in n)
        if not ms:
            log(f"profiler pass without {kernel_name}: {sorted(by_kernel)[:4]}")
            continue
        log(f"{kernel_name}: profiler {ms:.4f} ms, CUDA events {events_ms:.4f} ms, host {host_ms:.4f} ms a call"
            f"{'' if card_bound else ' (host-bound: the events time the host)'}")
        if ms > 2.0 * events_ms or (card_bound and ms < 0.5 * events_ms):
            refused.append(ms)
            continue
        return ms, "profiler", by_kernel, events_ms
    if refused:
        raise AssertionError(f"{kernel_name}: the profiler read {refused} ms against {events_ms:.4f} ms by CUDA "
                             f"events: more than 2x apart in every pass")
    log(f"{kernel_name} timed with CUDA events")
    return events_ms, "cuda_events", {}, events_ms


def _mismatch(out, ref, dtype=None) -> dict:
    import torch

    dtype = dtype or torch.float32
    out, ref = out.to(dtype), ref.to(dtype)
    diff = out - ref
    ref_rms = ref.square().mean().sqrt().item()
    return {
        "max_abs_err": diff.abs().max().item(),
        "max_rel_err": diff.abs().max().item() / ref.abs().max().item(),
        "rms_rel_err": diff.square().mean().sqrt().item() / ref_rms,
        "ref_rms": ref_rms,
        "finite": bool(torch.isfinite(out).all()),
    }


def _accepted(m: dict, max_rel: float = TOL_MAX_REL, rms_rel: float = TOL_RMS_REL) -> bool:
    return m["finite"] and m["max_rel_err"] <= max_rel and m["rms_rel_err"] <= rms_rel


def _check_case(name, b, h, t_q, t_k, d, n_valid, gen, bucket=False):
    """One flash forward case against its plain version. n_valid: keys
    valid per row (None: no mask); without `bucket` the second and later
    rows keep more (ragged), with it every row keeps the first n_valid, as
    a token bucket's padding mask does."""
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    dev = torch.device("cuda")
    # Token-major (B, T, H*D) storage viewed as (B, H, T, D): the layout the
    # DiT hands the kernel.
    q = torch.randn(b, t_q, h * d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, t_k, h * d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, t_k, h * d, device=dev, generator=gen).to(torch.bfloat16)
    qh, kh, vh = (x.view(b, -1, h, d).transpose(1, 2) for x in (q, k, v))
    kv_valid = None
    if n_valid is not None:
        kv_valid = torch.zeros(b, t_k, dtype=torch.bool, device=dev)
        kv_valid[:, :n_valid] = True
        if not bucket:
            kv_valid[1:, n_valid // 2:] = True  # the second row keeps more keys
    scale = d ** -0.5

    out = flash_attention(qh, kh, vh, scale, kv_valid)
    ref = flash_attention_plain(qh, kh, vh, scale, kv_valid)
    m = _mismatch(out, ref)

    # Planted faults, checked against the same limits.
    dropped = torch.ones(b, t_k, dtype=torch.bool, device=dev) if kv_valid is None else kv_valid.clone()
    dropped[:, 64:128] = False
    planted = {
        "tile_dropped": _mismatch(flash_attention_plain(qh, kh, vh, scale, dropped), ref),
        "scaled_1.03": _mismatch(ref.float() * 1.03, ref),
    }
    if kv_valid is not None:  # the kernel itself with its mask dropped
        planted["mask_dropped"] = _mismatch(flash_attention(qh, kh, vh, scale, None), ref)
    torch.cuda.synchronize()

    ms = _time_ms(lambda: flash_attention(qh, kh, vh, scale, kv_valid), 20)
    # The wrapper launches the kernel alone (and allocates the output), so
    # CUDA events can stand in for the profiler.
    kernel_ms, kernel_timed_by, _, kernel_events = _kernel_ms(
        lambda: flash_attention(qh, kh, vh, scale, kv_valid), "flash_fwd_kernel", 10)
    plain_ms = _time_ms(lambda: flash_attention_plain(qh, kh, vh, scale, kv_valid), 3)
    qc, kc, vc = (x.contiguous() for x in (qh, kh, vh))
    lib_mask = None if kv_valid is None else kv_valid[:, None, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=lib_mask, scale=scale), 20
    )
    keys = t_k * b if kv_valid is None else int(kv_valid.sum().item())
    flops = 4.0 * h * t_q * d * keys
    nbytes = 2.0 * (2 * b * h * t_q * d + 2 * b * h * t_k * d) + (0 if kv_valid is None else b * t_k)
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    rec = {
        "case": name, "shape": [b, h, t_q, t_k, d], "valid_keys": keys, **{k: m[k] for k in m if k != "finite"},
        "tol_max_rel": TOL_MAX_REL, "tol_rms_rel": TOL_RMS_REL,
        "planted_rms_rel": {k: p["rms_rel_err"] for k, p in planted.items()},
        "ms": ms, "kernel_ms": kernel_ms, "kernel_timed_by": kernel_timed_by, "kernel_events_ms": kernel_events,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "tflops": flops / ms / 1e9,
        "kernel_tflops": flops / kernel_ms / 1e9,
    }
    log(f"kernel check {name}: {json.dumps(rec)}")
    if not _accepted(m):
        raise AssertionError(f"flash_attention {name}: {m} outside max_rel {TOL_MAX_REL}, rms_rel {TOL_RMS_REL}")
    for fault, p in planted.items():
        if _accepted(p):
            raise AssertionError(f"flash_attention {name}: the check accepts a planted fault {fault}: {p}")
    return rec


def phase_kernels():
    import torch

    from ltx2_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    before, before_key_valid = flash_attention.launches, flash_attention.key_valid_launches
    recs = [
        _check_case("self", 1, 32, 6144, 6144, 128, None, gen),
        _check_case("cross", 1, 32, 6144, 1024, 128, None, gen),
        _check_case("masked_ragged", 2, 32, 1000, 333, 128, 200, gen),
        _check_case("d64", 1, 32, 2048, 2048, 64, None, gen),
        _check_case("stage1_self", 1, 32, 1536, 1536, 128, None, gen),
        # The one-stage CFG pipeline at its defaults: two guidance rows of
        # 4290 tokens (13 x 15 x 22 latent voxels; ragged query and key
        # tails, no key mask), and their text cross-attention.
        _check_case("one_stage_self", 2, 32, 4290, 4290, 128, None, gen),
        _check_case("one_stage_cross", 2, 32, 4290, 1024, 128, None, gen),
        # The one-stage loop options: a 512 token bucket pads 4290 tokens to
        # 4608 (key tiles 34 and 35 wholly masked, 33 partly) at the STG
        # rows' batch 3, the corrector's batch 2 at a 4352 bucket (only the
        # last tile partly valid), and the STG rows' cross-attention.
        _check_case("bucket_self_b3", 3, 32, 4608, 4608, 128, 4290, gen, bucket=True),
        _check_case("bucket_tail_b2", 2, 32, 4352, 4352, 128, 4290, gen, bucket=True),
        _check_case("stg_cross_b3", 3, 32, 4608, 1024, 128, None, gen),
        # The audio-video DiT's D = 64 attentions: the audio stream's 126
        # tokens (121 frames at 24 fps) attend to themselves (one ragged key
        # tile) and to the 1024 text tokens (with a Gemma key mask too); the
        # video's 6144 (stage 2) or 1536 (stage 1) tokens attend to the
        # audio's (a2v) and the audio's to the video's (v2a: 32 query rows).
        _check_case("audio_self", 1, 32, 126, 126, 64, None, gen),
        _check_case("audio_text", 1, 32, 126, 1024, 64, None, gen),
        _check_case("audio_text_masked", 1, 32, 126, 1024, 64, 300, gen, bucket=True),
        _check_case("a2v_s2", 1, 32, 6144, 126, 64, None, gen),
        _check_case("a2v_s1", 1, 32, 1536, 126, 64, None, gen),
        _check_case("v2a_s2", 1, 32, 126, 6144, 64, None, gen),
        _check_case("v2a_s1", 1, 32, 126, 1536, 64, None, gen),
        # The two-stage CFG pipeline's stage 1: the multi-modal guider's
        # three rows (cond, uncond, modality-isolated) at batch 3 over 1536
        # video and 126 audio tokens, at both head dims.
        _check_case("mm_video_self_b3", 3, 32, 1536, 1536, 128, None, gen),
        _check_case("mm_video_text_b3", 3, 32, 1536, 1024, 128, None, gen),
        _check_case("mm_audio_self_b3", 3, 32, 126, 126, 64, None, gen),
        _check_case("mm_audio_text_b3", 3, 32, 126, 1024, 64, None, gen),
        _check_case("mm_a2v_b3", 3, 32, 1536, 126, 64, None, gen),
        _check_case("mm_v2a_b3", 3, 32, 126, 1536, 64, None, gen),
        # Keyframe interpolation at 512x768x121 with two keyframes appended
        # past the sequence: stage 1's CFG rows over 1536 + 2 x 96 = 1728
        # tokens (ragged query and key tails) and their text cross-attention,
        # stage 2's one row over 6144 + 2 x 384 = 6912; ti2vid-hq's stage-1
        # rows at batch 2 over 1536 tokens.
        _check_case("keyframe_s1_self_b2", 2, 32, 1728, 1728, 128, None, gen),
        _check_case("keyframe_s1_text_b2", 2, 32, 1728, 1024, 128, None, gen),
        _check_case("keyframe_s2_self", 1, 32, 6912, 6912, 128, None, gen),
        _check_case("hq_s1_self_b2", 2, 32, 1536, 1536, 128, None, gen),
    ]
    flash_attention.launches = before  # comparison launches are not the main path's
    flash_attention.key_valid_launches = before_key_valid
    flash_attention.launches_by_head_dim = {}
    flash_attention.launches_by_batch = {}
    flash_attention.launches_by_length = {}
    return recs


# Conv cases: (name, x shape (B, T, H, W, Cin), Cout, kT, dtype, causal,
# spatial mode, temporal mode[, stride]), at the shapes the serving paths
# and the full video VAE give the kernel.
CONV_CASES = (
    ("S4", (1, 121, 128, 192, 128), 128, 3, "bfloat16", False, "reflect", "replicate"),
    ("S3", (1, 61, 64, 96, 256), 256, 3, "bfloat16", False, "reflect", "replicate"),
    ("conv_out_tile", (1, 57, 128, 128, 128), 48, 3, "bfloat16", False, "reflect", "replicate"),
    ("causal_ragged", (2, 7, 30, 44, 128), 128, 3, "bfloat16", True, "reflect", "replicate"),
    ("S1_tile_res", (1, 8, 16, 16, 1024), 1024, 3, "bfloat16", False, "reflect", "replicate"),
    ("S2_tile_up", (1, 15, 32, 32, 512), 2048, 3, "bfloat16", False, "reflect", "replicate"),
    # On a tile of the one-stage decode (480x704x97: latent tiles of
    # 8 x 15 x 16, 15 rows where the two-stage tiles have 16): a stage-1
    # res conv and conv_out on its 57 x 120 x 128 pixels.
    ("one_stage_tile_res", (1, 8, 15, 16, 1024), 1024, 3, "bfloat16", False, "reflect", "replicate"),
    ("one_stage_conv_out", (1, 57, 120, 128, 128), 48, 3, "bfloat16", False, "reflect", "replicate"),
    ("upscaler", (1, 16, 16, 24, 1024), 1024, 3, "float32", False, "zeros", "zeros"),
    ("resampler", (1, 16, 8, 12, 1024), 4096, 1, "float32", False, "zeros", "zeros"),
    ("upscaler_in", (1, 16, 8, 12, 128), 1024, 3, "float32", False, "zeros", "zeros"),
    ("upscaler_lowres", (1, 16, 8, 12, 1024), 1024, 3, "float32", False, "zeros", "zeros"),
    ("upscaler_out", (1, 16, 16, 24, 1024), 128, 3, "float32", False, "zeros", "zeros"),
    # The video VAE encoder (fp32, causal, zero spatial and replicate
    # temporal padding) on one 512x768 frame: conv_in (Cin 48, a K step and
    # a half), a 512-wide res conv, conv_out's 129 outputs (through the
    # module's padding to 136), and at 256x384 a 1024-wide res conv over 96
    # voxels, which splits K.
    ("enc_in", (1, 1, 128, 192, 48), 128, 3, "float32", True, "zeros", "replicate"),
    ("enc_res512", (1, 1, 64, 96, 512), 512, 3, "float32", True, "zeros", "replicate"),
    ("enc_out", (1, 1, 16, 24, 1024), 129, 3, "float32", True, "zeros", "replicate"),
    ("enc_res1024_split", (1, 1, 8, 12, 1024), 1024, 3, "float32", True, "zeros", "replicate"),
    # The same encoder on a whole 512x768x121 clip (retake's source, ic-lora's
    # control): a 128-wide res conv over the 121 x 128 x 192 voxels of the
    # first stage, and a 512-wide one over the 61 x 64 x 96 of the third.
    ("enc121_res128", (1, 121, 128, 192, 128), 128, 3, "float32", True, "zeros", "replicate"),
    ("enc121_res512", (1, 61, 64, 96, 512), 512, 3, "float32", True, "zeros", "replicate"),
    # The temporal upscaler (fp32, zero padding, non-causal) on a 512x768x121
    # latent (16 x 16 x 24): the initial 128 -> 512, a 512 res conv before
    # the shuffle, the upsampler's 512 -> 1024, a 512 res conv after it on
    # the 31 frames, and the final 512 -> 128.
    ("temporal_in", (1, 16, 16, 24, 128), 512, 3, "float32", False, "zeros", "zeros"),
    ("temporal_res", (1, 16, 16, 24, 512), 512, 3, "float32", False, "zeros", "zeros"),
    ("temporal_up", (1, 16, 16, 24, 512), 1024, 3, "float32", False, "zeros", "zeros"),
    ("temporal_res_post", (1, 31, 16, 24, 512), 512, 3, "float32", False, "zeros", "zeros"),
    ("temporal_out", (1, 31, 16, 24, 512), 128, 3, "float32", False, "zeros", "zeros"),
    # The full video VAE's strided causal convs (compress_space, _time and
    # _all of the strided encoder vocabulary) on a 17 x 256 x 384 clip, in
    # the encoder's fp32 and in bf16, and a ragged one: odd T, H and W,
    # where the causal front pad of 2 frames meets sT = 2.
    ("full_space_s122", (1, 17, 64, 96, 128), 128, 3, "float32", True, "zeros", "replicate", (1, 2, 2)),
    ("full_time_s211", (1, 17, 32, 48, 256), 256, 3, "float32", True, "zeros", "replicate", (2, 1, 1)),
    ("full_all_s222", (1, 9, 32, 48, 512), 512, 3, "float32", True, "zeros", "replicate", (2, 2, 2)),
    ("full_ragged_s222", (1, 17, 63, 95, 128), 128, 3, "float32", True, "zeros", "replicate", (2, 2, 2)),
    ("full_space_s122_bf16", (1, 17, 64, 96, 128), 128, 3, "bfloat16", True, "zeros", "replicate", (1, 2, 2)),
    ("full_time_s211_bf16", (1, 17, 32, 48, 256), 256, 3, "bfloat16", True, "zeros", "replicate", (2, 1, 1)),
    ("full_all_s222_bf16", (1, 9, 32, 48, 512), 512, 3, "bfloat16", True, "zeros", "replicate", (2, 2, 2)),
    ("full_ragged_s222_bf16", (1, 17, 63, 95, 128), 128, 3, "bfloat16", True, "reflect", "replicate", (2, 2, 2)),
    # The W-valid mode (a W-sharded decode's rank, its halo columns in
    # place): the decoder's S4 conv split over 2 ranks (96 output columns
    # of 192, 98 in), bf16; and the decoder's first stage of the 512x768
    # clip split over 2 (12 of 24 latent columns, 14 in) in fp32, the
    # JAX package's decoder dtype.
    ("S4_w_valid_half", (1, 121, 128, 98, 128), 128, 3, "bfloat16", False, "reflect", "replicate", (1, 1, 1), True),
    ("S1_w_valid_half_fp32", (1, 16, 16, 14, 1024), 1024, 3, "float32", False, "reflect", "replicate", (1, 1, 1),
     True),
)
# The spatial upscaler's convs in one two-stage clip (all fp32): the
# initial conv, 8 res convs before and 8 after the resampler, the final.
UPSCALER_LAUNCHES = {"upscaler_in": 1, "upscaler_lowres": 8, "resampler": 1, "upscaler": 8, "upscaler_out": 1}
# The temporal upscaler's 19 convs in one call: the initial conv, 8 res
# convs before the shuffle, the upsampler, 8 after it, the final.
TEMPORAL_LAUNCHES = {"temporal_in": 1, "temporal_res": 8, "temporal_up": 1, "temporal_res_post": 8,
                     "temporal_out": 1}
TOL_UPSCALER_CONV_TIME = 0.10  # the cases' times x launches against a traced upscaler call
F64_FRAMES = 16  # the float64 check's output frames on a long causal clip


def _conv_case(name, shape, cout, kt, dtype_name, causal, spatial_mode, temporal_mode, gen, stride=(1, 1, 1),
               w_valid=False):
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc
    from ltx2_tpu_torch.ops.conv3d import (
        conv3d_ndhwc_kernel, conv3d_plain, kernel_layout, out_shape, tf32_round, tf32x3_plan, tf32x3_split, wgmma_tile,
    )

    dev, dtype = torch.device("cuda"), getattr(torch, dtype_name)
    fp32 = dtype == torch.float32
    b, t, h, w, cin = shape
    voxels_out = math.prod(out_shape(shape, cout, stride, w_valid)[:4])
    bound_w = (cin * kt * 9) ** -0.5  # the models' init: U(+-1/sqrt(fan_in))
    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
    weight = ((torch.rand(cout, cin, kt, 3, 3, device=dev, generator=gen) * 2 - 1) * bound_w).to(dtype)
    bias = (torch.rand(cout, device=dev, generator=gen) * 2 - 1) * bound_w
    wk = kernel_layout(weight, k_major=not fp32)  # bf16: the order the kernel reads, as cached
    args = (causal, spatial_mode, temporal_mode)
    kw = {"stride": stride, "w_valid": w_valid}
    if cout % 8:
        # A Cout the kernel does not take runs through the module, which pads
        # its weight and bias with zero outputs and slices them off.
        module = Conv3d(cin, cout, device=dev, dtype=dtype)
        with torch.no_grad():
            module.weight.copy_(weight)
            module.bias.copy_(bias)
        split = module.tf32x3_weight() if fp32 else None

        def call():
            return conv3d_ndhwc(module, x, *args, stride=stride)
    else:
        split = tf32x3_split(wk) if fp32 else None  # fp32: the TF32 parts the module caches

        def call():
            return conv3d_ndhwc_kernel(x, wk, bias, *args, w_split=split, **kw)

    out = call()
    ref = conv3d_plain(x, wk, bias, *args, **kw)
    m = _mismatch(out, ref)
    # Planted faults, held to the same limits: one tap left out, and the
    # output off by 3 %.
    dropped = wk.clone()
    dropped[kt // 2, 1, 1] = 0
    planted = {"tap_dropped": _mismatch(conv3d_plain(x, dropped, bias, *args, **kw), ref),
               "scaled_1.03": _mismatch(ref.float() * 1.03, ref)}
    del dropped
    torch.cuda.empty_cache()
    f64 = {}
    if fp32:
        # fp32 accuracy: the kernel and the fp32 plain version against the
        # plain version in float64; single-pass TF32 planted against it too.
        # A long causal clip on its first F64_FRAMES output frames, which
        # depend on the first F64_FRAMES input frames alone: the float64
        # im2col of 121 x 128 x 192 voxels would take 25.5 GiB.
        # (With a temporal stride, the output frames those input frames give.)
        win = F64_FRAMES if causal and t > F64_FRAMES else t
        xw = x[:, :win]
        ref64 = conv3d_plain(xw.double(), wk.double(), bias.double(), *args, **kw)
        n_out = ref64.shape[1]
        f64 = {"kernel": _mismatch(out[:, :n_out], ref64, torch.float64),
               "plain_fp32": _mismatch(ref[:, :n_out], ref64, torch.float64),
               "single_pass_tf32": _mismatch(conv3d_plain(tf32_round(xw), tf32_round(wk), bias, *args, **kw),
                                             ref64, torch.float64)}
        del ref64, xw
        # The K ranges are summed in a fixed order: two runs agree bitwise.
        f64["bitwise_reproducible"] = bool(torch.equal(call(), out))
    del out, ref
    torch.cuda.synchronize()

    ms = _time_ms(call, 10)
    # fp32: the kernel and, when K is split, the sum of the ranges.
    kernel_name = "conv3d_tf32x3" if fp32 else "conv3d_wgmma_kernel"
    # The wrapper launches the kernel alone (the weights are already in the
    # order it reads), or the fp32 kernel and its sum, so CUDA events can
    # stand in for the profiler. Ten profiled calls, as the flash cases take:
    # on an NVIDIA H100 80GB HBM3 (700 W) the mean of three read the 1024 ->
    # 1024 fp32 case at 2.83-3.12 ms while CUDA events read 2.77-2.84 in the
    # same runs, enough to throw the upscaler comparison below past 10 %.
    kernel_ms, kernel_timed_by, _, kernel_events = _kernel_ms(call, kernel_name, 10)
    plain_ms = _time_ms(lambda: conv3d_plain(x, wk, bias, *args, **kw), 2)
    # Library yardstick, never called by the port: cuDNN's conv3d in the same
    # dtype (TF32 off), on the NCDHW view of the channels-last input. Zero
    # padding is its own; reflect/replicate padding is applied beforehand and
    # not timed.
    if spatial_mode == "zeros" and temporal_mode == "zeros":
        lib_in, lib_pad = x.permute(0, 4, 1, 2, 3), ((kt - 1) // 2, 1, 0 if w_valid else 1)
    else:
        from ltx2_tpu_torch.ops.conv3d import _pad

        lib_in, lib_pad = _pad(x, kt, causal, spatial_mode, temporal_mode, w_valid).permute(0, 4, 1, 2, 3), 0
    lib_b = bias.to(dtype)
    library_ms = _time_ms(lambda: F.conv3d(lib_in, weight, lib_b, padding=lib_pad, stride=stride), 10)
    del lib_in

    flops = 2.0 * voxels_out * cin * cout * kt * 9
    nbytes = x.element_size() * (x.numel() + wk.numel() + voxels_out * cout) + 4 * cout
    # fp32 work runs as three TF32 products; the FFMA bound is kept beside it.
    op_s = 3 * flops / PEAK_TF32_FLOPS if fp32 else flops / PEAK_BF16_FLOPS
    bound_ms = max(op_s, nbytes / PEAK_BYTES_PER_S) * 1e3
    tol = CONV_TOL[dtype_name]
    rec = {
        "case": name, "shape": list(shape), "cout": cout, "kt": kt, "stride": list(stride), "dtype": dtype_name,
        "causal": causal, "w_valid": w_valid,
        "spatial_mode": spatial_mode, "temporal_mode": temporal_mode,
        **{k: m[k] for k in m if k != "finite"}, "tol_max_rel": tol[0], "tol_rms_rel": tol[1],
        "planted_rms_rel": {k: p["rms_rel_err"] for k, p in planted.items()},
        "kernel": "conv3d_tf32x3_kernel" if fp32 else "conv3d_wgmma_kernel", "kernel_cout": -(-cout // 8) * 8,
        "tile": [128, 128] if fp32 else list(wgmma_tile(cout)),
        "ms": ms, "kernel_ms": kernel_ms, "kernel_timed_by": kernel_timed_by, "kernel_events_ms": kernel_events,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if op_s >= nbytes / PEAK_BYTES_PER_S else "bytes",
        "tflops": flops / ms / 1e9, "library_tflops": flops / library_ms / 1e9,
    }
    if fp32:
        rec.update({
            "k_ranges": tf32x3_plan(voxels_out, -(-cout // 8) * 8, cin, kt, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)[0],
            "ffma_bound_ms": max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3,
            "launches_a_clip": UPSCALER_LAUNCHES.get(name, TEMPORAL_LAUNCHES.get(name)),
            "f64": {k: v if isinstance(v, bool) else {"max_rel": v["max_rel_err"], "rms_rel": v["rms_rel_err"]}
                    for k, v in f64.items()}, "f64_frames": win,
            "tol_f64_max_rel": CONV_TOL_F64[0], "tol_f64_rms_rel": CONV_TOL_F64[1],
        })
    log(f"conv kernel check {name}: {json.dumps(rec)}")
    if not _accepted(m, *tol):
        raise AssertionError(f"conv3d {name}: {m} outside max_rel {tol[0]}, rms_rel {tol[1]}")
    for fault, p in planted.items():
        if _accepted(p, *tol):
            raise AssertionError(f"conv3d {name}: the check accepts a planted fault {fault}: {p}")
    if fp32:
        if not _accepted(f64["kernel"], *CONV_TOL_F64):
            raise AssertionError(f"conv3d {name}: {f64['kernel']} against float64 outside {CONV_TOL_F64}")
        if _accepted(f64["single_pass_tf32"], *CONV_TOL_F64):
            raise AssertionError(f"conv3d {name}: the float64 check accepts single-pass TF32 "
                                 f"{f64['single_pass_tf32']}")
        if not f64["bitwise_reproducible"]:
            raise AssertionError(f"conv3d {name}: two runs of the fp32 kernel differ")
    del x, weight, wk, split
    torch.cuda.empty_cache()
    return rec


def phase_conv_kernels():
    import torch

    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

    gen = torch.Generator(device="cuda").manual_seed(2)
    before, before_strided = conv3d_ndhwc_kernel.launches, conv3d_ndhwc_kernel.strided_launches
    before_w_valid = conv3d_ndhwc_kernel.w_valid_launches
    recs = []
    for case in CONV_CASES:
        t0 = time.perf_counter()
        recs.append(_conv_case(*case[:8], gen, *case[8:]))
        recs[-1]["case_s"] = time.perf_counter() - t0  # the check, its float64 and its timings
    log(f"conv kernel checks: {sum(r['case_s'] for r in recs):.1f} s, the strided ones "
        f"{sum(r['case_s'] for r in recs if r['stride'] != [1, 1, 1]):.1f} s, the W-valid ones "
        f"{sum(r['case_s'] for r in recs if r['w_valid']):.1f} s")
    # A shape the kernel does not take raises on the card; nothing falls back.
    from ltx2_tpu_torch.ops.conv3d import conv3d

    x = torch.zeros(1, 2, 4, 4, 24, device="cuda", dtype=torch.bfloat16)
    try:
        conv3d(x, torch.zeros(3, 3, 3, 24, 8, device="cuda", dtype=torch.bfloat16))
    except ValueError:
        pass
    else:
        raise AssertionError("conv3d accepted Cin = 24 on the card")
    conv3d_ndhwc_kernel.launches = before  # comparison launches are not the main path's
    conv3d_ndhwc_kernel.strided_launches = before_strided
    conv3d_ndhwc_kernel.w_valid_launches = before_w_valid
    return recs


def phase_upscaler_conv_time(conv_recs, smi: str) -> dict:
    """The fp32 cases' kernel times x their launches a clip against the
    conv kernels' device time in one traced call of the full-width spatial
    upscaler on a stage-1 latent (as profile_slice.py's upscale phase runs
    it), within TOL_UPSCALER_CONV_TIME. Its launches are not the main
    path's. Where the profiler records no device event, the comparison is
    reported as not measured."""
    import torch

    from ltx2_tpu_torch.generate import make_upscaler
    from ltx2_tpu_torch.models.upscaler.spatial import spatial_upscaler_apply
    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

    before = conv3d_ndhwc_kernel.launches
    upscaler = make_upscaler(torch.device("cuda"))
    latent = torch.randn(1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 64, WIDTH // 64, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    by_kernel = {}
    for _ in range(2):
        by_kernel = _device_ms(lambda: spatial_upscaler_apply(upscaler, latent), 1)
        if by_kernel:
            break
    cache = torch.cuda.memory_allocated() - weights  # what the first call left: the TF32 split of every conv
    del upscaler
    torch.cuda.empty_cache()
    conv3d_ndhwc_kernel.launches = before
    predicted = sum(r["kernel_ms"] * r["launches_a_clip"] for r in conv_recs if r["case"] in UPSCALER_LAUNCHES)
    rec = {"cases_ms_x_launches": predicted, "traced_conv_ms": None, "traced_conv_launches": None,
           "traced_device_ms": None, "weights_and_latent_gb": weights / 1e9, "tf32x3_cache_gb": cache / 1e9}
    if not by_kernel:
        log(f"upscaler conv time: profiler recorded no device events; not measured | {smi}")
        return rec
    rec["traced_conv_ms"] = sum(ms for n, (ms, _) in by_kernel.items() if "conv3d_tf32x3_kernel" in n or
                                "conv3d_tf32x3_sum" in n)
    rec["traced_conv_launches"] = sum(c for n, (_, c) in by_kernel.items() if "conv3d_tf32x3_kernel" in n)
    rec["traced_device_ms"] = sum(ms for ms, _ in by_kernel.values())
    log(f"upscaler conv time: {json.dumps(rec)} | {smi}")
    if abs(predicted / rec["traced_conv_ms"] - 1) > TOL_UPSCALER_CONV_TIME:
        raise AssertionError(f"upscaler conv time {rec['traced_conv_ms']} ms traced, {predicted} ms from the "
                             f"cases: outside {TOL_UPSCALER_CONV_TIME:.0%}")
    if rec["traced_conv_launches"] != sum(UPSCALER_LAUNCHES.values()):
        raise AssertionError(f"{rec['traced_conv_launches']} fp32 conv kernels in the traced upscaler call")
    return rec


def _bwd_inputs(b, h, t_q, t_k, d, n_valid, gen):
    import torch

    dev = torch.device("cuda")
    # Token-major (B, T, H*D) storage viewed as (B, H, T, D), as the DiT
    # hands the kernels its activations and gets gradients back.
    q, k, v, do = (torch.randn(b, t, h * d, device=dev, generator=gen).to(torch.bfloat16).view(b, t, h, d)
                   .transpose(1, 2) for t in (t_q, t_k, t_k, t_q))
    kv_valid = None
    if n_valid is not None:
        kv_valid = torch.zeros(b, t_k, dtype=torch.bool, device=dev)
        kv_valid[:, :n_valid] = True
        kv_valid[1:, n_valid // 2:] = True
    return q, k, v, do, kv_valid


def _bwd_case(name, b, h, t_q, t_k, d, n_valid, gen):
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops import attention as A

    q, k, v, do, kv_valid = _bwd_inputs(b, h, t_q, t_k, d, n_valid, gen)
    scale = d ** -0.5

    # Forward residuals: kernel against plain.
    o, l, m = A.flash_attention_residuals(q, k, v, scale, kv_valid)
    o_ref, l_ref, m_ref = A.flash_attention_residuals_plain(q, k, v, scale, kv_valid)
    res = {"l": _mismatch(l, l_ref), "m": _mismatch(m, m_ref)}
    del o_ref

    grads = A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid)
    torch.cuda.synchronize()
    # Reference 1: the plain backward from the plain forward's residuals.
    ref1 = A.flash_attention_bwd_plain(q, k, v, *A.flash_attention_residuals_plain(q, k, v, scale, kv_valid),
                                       do, scale, kv_valid)
    checks = {f"{g}_vs_plain_bwd": _mismatch(x, r) for g, x, r in zip(("dq", "dk", "dv"), grads, ref1)}
    del ref1
    # Reference 2: autograd of the plain forward in fp32.
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = A.flash_attention_plain(*leaves, scale, kv_valid)
    ref2 = torch.autograd.grad(out, leaves, do.float())
    del out, leaves
    checks.update({f"{g}_vs_autograd": _mismatch(x, r) for g, x, r in zip(("dq", "dk", "dv"), grads, ref2)})

    # Planted faults, held to the same limits: dq x 1.03, and one 64-key
    # tile left out of dk and dv.
    dq, dk, dv = grads
    dk_drop, dv_drop = dk.clone(), dv.clone()
    dk_drop[:, :, 64:128] = 0
    dv_drop[:, :, 64:128] = 0
    planted = {
        "dq_scaled_1.03": _mismatch(dq.float() * 1.03, ref2[0]),
        "dk_tile_dropped": _mismatch(dk_drop, ref2[1]),
        "dv_tile_dropped": _mismatch(dv_drop, ref2[2]),
    }
    del ref2, dk_drop, dv_drop
    torch.cuda.synchronize()

    bwd_ms = _time_ms(lambda: A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid), 10)
    # The fused kernel's own device time, apart from the accumulator's
    # zeroing, the dQ conversion and Di, from one profiled pass (CUDA events
    # around the wrapper, Di computed beforehand, if the profiler sees none).
    di = (o.float() * do).sum(dim=-1).contiguous()
    kernel_ms, kernel_timed_by, by_kernel, kernel_events = _kernel_ms(
        lambda: A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid), "flash_bwd_kernel", 5,
        lambda: A.flash_attention_bwd_kernel(q, k, v, do, l, m, di, scale, kv_valid))
    del di
    plain_ms = _time_ms(lambda: A.flash_attention_bwd_plain(q, k, v, o, l, m, do, scale, kv_valid), 2)
    # Library yardstick, never called by the port: the backward alone of
    # scaled_dot_product_attention on the same (contiguous) inputs, and the
    # kernels it ran.
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=None if kv_valid is None else kv_valid[:, None, None, :], scale=scale)
    doc = do.contiguous()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qc, kc, vc), doc, retain_graph=True)  # noqa: E731
    library_ms = _time_ms(lib_bwd, 10)
    library_kernels = {n[:100]: round(ms, 4) for n, (ms, _) in sorted(_device_ms(lib_bwd, 3).items(),
                                                                        key=lambda kv: -kv[1][0])[:4]}
    del lib_out, qc, kc, vc

    keys = t_k * b if kv_valid is None else int(kv_valid.sum().item())
    unit = 2.0 * h * t_q * d * keys  # FLOP of one (T_q x keys x D) product over the batch
    elems_q, elems_k = b * h * t_q * d, b * h * t_k * d
    stats_bytes = 3 * 4 * b * h * t_q + (0 if kv_valid is None else b * t_k)
    # The whole backward: five products (S, dP, dV, dK, dQ); reads q, k, v,
    # o, dO, l, m and writes dq, dk, dv (Di is made inside).
    flops = 5 * unit
    nbytes = 2.0 * (3 * elems_q + 2 * elems_k) + 2.0 * (elems_q + 2 * elems_k) + stats_bytes - 4 * b * h * t_q
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    rec = {
        "case": name, "shape": [b, h, t_q, t_k, d], "valid_keys": keys,
        "residuals": {k_: {x: r[x] for x in ("max_rel_err", "rms_rel_err", "max_abs_err")} for k_, r in res.items()},
        "grads": {k_: {x: r[x] for x in ("max_rel_err", "rms_rel_err", "max_abs_err")} for k_, r in checks.items()},
        "tol_max_rel": TOL_BWD_MAX_REL, "tol_rms_rel": TOL_BWD_RMS_REL, "tol_residuals_rel": TOL_RES_REL,
        "planted_rms_rel": {k_: p["rms_rel_err"] for k_, p in planted.items()},
        "bwd_ms": bwd_ms, "kernel_ms": kernel_ms, "kernel_timed_by": kernel_timed_by,
        "kernel_events_ms": kernel_events,
        "device_ms_by_kernel": {n[:80]: v_[0] for n, v_ in by_kernel.items()},
        "plain_ms": plain_ms, "library_ms": library_ms, "library_kernels": library_kernels,
        "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bwd_tflops": flops / bwd_ms / 1e9, "kernel_tflops": flops / kernel_ms / 1e9 if kernel_ms else None,
        "max_abs_err_grads": max(checks[f"{g}_vs_autograd"]["max_abs_err"] for g in ("dq", "dk", "dv")),
        "max_abs_err_fwd_residuals": max(r["max_abs_err"] for r in res.values()),
    }
    log(f"backward check {name}: {json.dumps(rec)}")
    for what, r in res.items():
        if not _accepted(r, TOL_RES_REL, TOL_RES_REL):
            raise AssertionError(f"flash residual {name} {what}: {r} outside {TOL_RES_REL} relative")
    for what, r in checks.items():
        if not _accepted(r, TOL_BWD_MAX_REL, TOL_BWD_RMS_REL):
            raise AssertionError(f"flash backward {name} {what}: {r} outside max_rel {TOL_BWD_MAX_REL}, "
                                 f"rms_rel {TOL_BWD_RMS_REL}")
    for fault, p in planted.items():
        if _accepted(p, TOL_BWD_MAX_REL, TOL_BWD_RMS_REL):
            raise AssertionError(f"flash backward {name}: the check accepts a planted fault {fault}: {p}")
    return rec


# (name, batch, heads, T_q, T_k, head dim, valid keys): the video DiT's
# training shapes at head dim 128, then the AV DiT's at 64: the 126 audio
# tokens' self-attention (under one 128-key block, its second 64-row query
# tile ragged), audio -> video (6144 x 126), video -> audio (126 x 6144: dQ
# of 126 rows gathered from 48 key blocks), the audio text cross-attention
# with its key mask, and the dense 6144² at 64 as a yardstick.
BWD_CASES = (
    ("self", 1, 32, 6144, 6144, 128, None), ("cross", 1, 32, 6144, 1024, 128, None),
    ("masked_ragged", 2, 32, 1000, 333, 128, 200),
    ("bwd_audio_self", 1, 32, 126, 126, 64, None), ("bwd_a2v", 1, 32, 6144, 126, 64, None),
    ("bwd_v2a", 1, 32, 126, 6144, 64, None), ("bwd_audio_text_masked", 1, 32, 126, 1024, 64, 700),
    ("bwd_self_d64", 1, 32, 6144, 6144, 64, None),
)


def phase_bwd_kernels():
    import torch

    from ltx2_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    counters = (A.flash_attention, A.flash_attention_bwd_kernel)
    before = [c.launches for c in counters]
    recs = []
    for case in BWD_CASES:
        recs.append(_bwd_case(*case, gen))
        torch.cuda.empty_cache()
    for c, n in zip(counters, before):  # comparison launches are not the main path's
        c.launches = n
    _reset_flash_by()
    A.flash_attention_bwd_kernel.launches_by_head_dim = {}
    return recs


def phase_main_path(smi: str):
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import TEMPORAL_CHUNK, generate_videos
    from ltx2_tpu_torch.models.video_vae.chunking import temporal_chunks
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.ops.attention import flash_attention

    # Every decoder call runs 45 convs; the decode runs one call per chunk.
    convs_per_clip = conv_launches(VideoDecoderConfig()) * len(temporal_chunks((FRAMES - 1) // 8 + 1, TEMPORAL_CHUNK))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos(
        list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES, steps=STEPS,
        layers=LAYERS, device="cuda",
    )
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for s in stats:
        log(f"request seed={s['seed']}: denoise {s['denoise_s']:.3f} s, decode {s['decode_s']:.3f} s, "
            f"attention launches {s['attention_launches']}, conv launches {s['conv_launches']} | {smi}")
    log(f"main path: {len(SEEDS)} requests {WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, {STEPS} steps, fp8 DiT "
        f"weights {stats[0]['dit_weight_gb']:.2f} GB on the card, wall {wall:.1f} s (weight init "
        f"{stats[0]['dit_init_s']:.1f} s + decoder init {stats[0]['decoder_init_s']:.1f} s included), peak memory "
        f"{peak_gb:.1f} GB | {smi}")
    if not FP8_DIT_GB[0] < stats[0]["dit_weight_gb"] < FP8_DIT_GB[1]:
        raise AssertionError(f"bench-e2e's DiT holds {stats[0]['dit_weight_gb']} GB: not the fp8 DiT")

    for f in frames:
        if f.shape != (FRAMES, HEIGHT, WIDTH, 3) or f.dtype != np.uint8:
            raise AssertionError(f"frames {f.shape} {f.dtype}")
    for s in stats:
        if not s["latent_finite"]:
            raise AssertionError(f"seed {s['seed']}: non-finite latent")
        if s["attention_launches"] != LAUNCHES_PER_CLIP:
            raise AssertionError(f"seed {s['seed']}: {s['attention_launches']} attention launches, "
                                 f"expected {LAUNCHES_PER_CLIP}")
        if s["conv_launches"] != convs_per_clip:
            raise AssertionError(f"seed {s['seed']}: {s['conv_launches']} conv launches, expected {convs_per_clip}")
    if launches != LAUNCHES_PER_CLIP * len(SEEDS):
        raise AssertionError(f"{launches} kernel launches in the main path")
    if counts["conv"] != convs_per_clip * len(SEEDS) or counts["bwd"]:
        raise AssertionError(f"launches in the main path {counts}")
    if np.array_equal(frames[0], frames[1]):
        raise AssertionError("the two requests produced identical clips")
    log(f"frames: {[f.shape for f in frames]} uint8, latent std {[s['latent_std'] for s in stats]}, "
        f"frame mean/std {[(float(f.mean()), float(f.std())) for f in frames]}, mean |clip 1 - clip 2| "
        f"{float(np.abs(frames[0].astype(np.int16) - frames[1]).mean())} levels")
    return counts, {"dit_weight_gb": stats[0]["dit_weight_gb"], "dit_init_s": stats[0]["dit_init_s"],
                    "denoise_s": [s["denoise_s"] for s in stats], "decode_s": [s["decode_s"] for s in stats],
                    "peak_memory_gb": peak_gb, "wall_s": wall, "card": smi}


def phase_fp8_step(smi: str) -> tuple:
    """One traced step of bench-e2e's loop at 6144 tokens with the DiT's
    weights kept in fp8 (dequantized at use), then with the same weights in
    bf16 (profile_slice.denoise_step): device time, its busy share and the
    weights' bytes; the difference is the dequantization's cost. Then the
    bf16 DiT quantized in place to int8 W8A8 (`phase_int8`) and the same
    step again. Then the same step for the LTX-2.3 (V2) DiT in bf16 beside
    the V1 one: the cost of V2's gates and per-step text K/V modulation.
    Returns (the record, the int8 serving path's launch counts)."""
    import torch

    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.profile_slice import denoise_step

    dev, card = torch.device("cuda"), torch.cuda.get_device_name(0)
    recs = {}
    v2 = LTXModelConfig(cross_attention_adaln=True, apply_gated_attention=True)
    for name, fp8, base in (("fp8", True, LTXModelConfig()), ("bf16", False, LTXModelConfig()),
                            ("v2_bf16", False, v2)):
        torch.cuda.empty_cache()
        dit = make_dit(LAYERS, dev, fp8=fp8, base=base)
        with torch.no_grad():
            recs[name] = denoise_step(dit, HEIGHT, WIDTH, f"denoise_step_{name}", dev, card)[1]
        if name == "bf16":
            int8_rec, int8_counts = phase_int8(dit, smi)
            recs["int8"] = int8_rec.pop("step")
        del dit
    torch.cuda.empty_cache()
    rec = {name: {k: r[k] for k in ("weight_gb", "device_ms", "wall_ms", "busy_share", "device_ms_by_class")}
           for name, r in recs.items()}
    rec["int8_checks"] = int8_rec
    rec["dequant_ms"] = rec["fp8"]["device_ms"] - rec["bf16"]["device_ms"]
    # V2's gates, query AdaLN and per-step prompt modulation of the text K/V.
    rec["v2_extra_ms"] = rec["v2_bf16"]["device_ms"] - rec["bf16"]["device_ms"]
    rec["card"] = smi
    log(f"fp8 vs bf16 DiT step ({LAYERS} layers, 6144 tokens): {json.dumps(rec)}")
    log(f"V2 (LTX-2.3) vs V1 bf16 DiT step ({LAYERS} layers, 6144 tokens): V2 {rec['v2_bf16']['device_ms']:.1f} ms, "
        f"V1 {rec['bf16']['device_ms']:.1f} ms device time | {smi}")
    log(f"int8 vs fp8 vs bf16 DiT step ({LAYERS} layers, 6144 tokens): int8 {rec['int8']['device_ms']:.1f} ms, fp8 "
        f"{rec['fp8']['device_ms']:.1f} ms, bf16 {rec['bf16']['device_ms']:.1f} ms device time; weights int8 "
        f"{rec['int8']['weight_gb']:.2f} GB, fp8 {rec['fp8']['weight_gb']:.2f} GB, bf16 {rec['bf16']['weight_gb']:.2f}"
        f" GB | {smi}")
    if not rec["fp8"]["weight_gb"] < 0.55 * rec["bf16"]["weight_gb"]:
        raise AssertionError(f"the fp8 DiT is not half the bf16 one: {rec}")
    if not rec["int8"]["weight_gb"] < 0.55 * rec["bf16"]["weight_gb"]:
        raise AssertionError(f"the int8 DiT is not half the bf16 one: {rec}")
    return rec, int8_counts


def encode_flops(gemma_cfg, te_cfg, batch: int, tokens: int) -> dict:
    """FLOP of one encode by part, reckoned from the configs: Gemma's
    linears, its attention (dense: the plain route computes every masked
    logit too), the feature extractor's projection and the connector
    (linears and attention over `tokens`, as registers fill up to 1024)."""
    g, n = gemma_cfg, batch * tokens
    qd, kvd = g.num_attention_heads * g.head_dim, g.num_key_value_heads * g.head_dim
    per_layer = g.hidden_size * (2 * qd + 2 * kvd) + 3 * g.hidden_size * g.intermediate_size
    c = te_cfg.connector
    conn_tokens = batch * max(tokens, c.min_sequence_length)
    return {
        "gemma_linears": 2.0 * n * per_layer * g.num_hidden_layers,
        "gemma_attention": 4.0 * batch * g.num_attention_heads * tokens ** 2 * g.head_dim * g.num_hidden_layers,
        "extractor": 2.0 * n * te_cfg.hidden_dim * te_cfg.num_gemma_layers * te_cfg.hidden_dim,
        "connector": c.num_layers * (2.0 * conn_tokens * 12 * c.inner_dim ** 2
                                     + 4.0 * conn_tokens * max(tokens, c.min_sequence_length) * c.inner_dim),
    }


def phase_text_encode_check(smi: str, fp8: bool = False) -> dict:
    """The fp32 text encoder on the card against the CPU at a small size
    (ltx2_tpu_torch/models/text_encoder/card_check.py), Gemma's weights
    in fp8 with `fp8`."""
    import torch

    from ltx2_tpu_torch.models.text_encoder.card_check import encoder_against_cpu

    rec = encoder_against_cpu("cuda", fp8=fp8)
    torch.cuda.empty_cache()
    log(f"text encode check (2-layer full-width {'fp8' if fp8 else 'fp32'} Gemma + V1 encoder, card vs CPU): "
        f"{json.dumps(rec)} | {smi}")
    if not rec["ok"]:
        raise AssertionError(f"the text encoder on the card disagrees with the CPU: {rec['errors']}")
    return rec


def phase_text_encode(smi: str) -> dict:
    """The full-width fp32 Gemma-3-12B and V1 encoder on the card: init,
    two encodes of one request's 2 x 1024 prompt tokens (the second timed),
    peak memory, finiteness, and the encode's bound; no kernel launches."""
    import torch

    from ltx2_tpu_torch.generate import CONTEXT_TOKENS, encode_prompts, make_gemma, make_text_encoder
    from ltx2_tpu_torch.models.text_encoder.card_check import relative_error

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    gemma = make_gemma(dev)
    torch.cuda.synchronize()
    gemma_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = make_text_encoder(dev)
    torch.cuda.synchronize()
    te_init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for m in (gemma, enc) for p in m.parameters())
    weights_gb = torch.cuda.memory_allocated() / 1e9
    stats = [{"seed": SEEDS[0]}, {"seed": SEEDS[0]}]
    contexts = encode_prompts([SEEDS[0]] * 2, gemma, enc, dev, stats)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops = encode_flops(gemma.cfg, enc.cfg, 2, CONTEXT_TOKENS)
    total = sum(flops.values())
    # The least time of an fp32-accurate encode: 3xTF32 on the tensor cores
    # holds fp32 accuracy (the fp32 conv's check above shows it), three TF32
    # products per product; the FFMA bound is beside it.
    t_ops, t_ffma, t_bytes = 3 * total / PEAK_TF32_FLOPS, total / PEAK_FP32_FLOPS, weight_bytes / PEAK_BYTES_PER_S
    encode_s = stats[1]["text_encode_s"]
    repeat = relative_error(contexts[1], contexts[0])
    rec = {"gemma_params": sum(p.numel() for p in gemma.parameters()),
           "text_encoder_params": sum(p.numel() for p in enc.parameters()),
           "gemma_init_s": gemma_init_s, "text_encoder_init_s": te_init_s, "weights_gb": weights_gb,
           "encode_s": encode_s, "first_encode_s": stats[0]["text_encode_s"], "peak_memory_gb": peak_gb,
           "tokens": [2, CONTEXT_TOKENS], "prompt_tokens": stats[0]["prompt_tokens"],
           "negative_tokens": stats[0]["negative_tokens"], "context_shape": list(contexts[0].shape),
           "context_finite": all(s["context_finite"] for s in stats), "context_std": stats[1]["context_std"],
           "repeat_rel_err": repeat, "tflop": {k: v / 1e12 for k, v in flops.items()}, "tflop_total": total / 1e12,
           "bound_s": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "ffma_bound_s": max(t_ffma, t_bytes), "bytes_bound_s": t_bytes,
           "pct_of_bound": 100 * max(t_ops, t_bytes) / encode_s,
           "pct_of_ffma_bound": 100 * max(t_ffma, t_bytes) / encode_s,
           "tflops_achieved": total / encode_s / 1e12, "launches": counts,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": smi}
    log(f"text encode (full-width fp32 Gemma-3-12B + V1 encoder, 2 x {CONTEXT_TOKENS} tokens): {json.dumps(rec)}")
    rec["decode"] = phase_gemma_decode(gemma, smi)
    rec["fp8"] = _fp8_encode(gemma, enc, contexts[1], smi)
    del gemma, enc, contexts
    torch.cuda.empty_cache()
    if not rec["context_finite"] or rec["context_shape"] != [1, CONTEXT_TOKENS, 3840]:
        raise AssertionError(f"text encode output {rec}")
    if any(counts.values()) or rec["allow_tf32"]:
        raise AssertionError(f"the encode launched a kernel or ran TF32: {counts}")
    if repeat["max_rel"] > TOL_ENCODE_REPEAT_MAX_REL:
        raise AssertionError(f"two encodes of the same tokens differ: {repeat}")
    rec["card_vs_cpu"] = phase_text_encode_check(smi)
    rec["card_vs_cpu_fp8"] = phase_text_encode_check(smi, fp8=True)
    return rec


# The prompt enhancement's decode at full width: greedy, DECODE_NEW tokens
# after a DECODE_PROMPT-token prompt on the fp32 Gemma-3-12B; the cached
# decode's logits at the last DECODE_CHECK picks against an uncached
# gemma3_apply plus the LM head over the same ids (both fp32, TF32 off: the
# cache's attention sums in another order than sdpa's plain route).
DECODE_PROMPT, DECODE_NEW, DECODE_CHECK = 256, 32, 4
TOL_DECODE_MAX_REL = 1e-4  # of max|logits|
TOL_DECODE_RMS_REL = 1e-5


def phase_gemma_decode(gemma, smi: str) -> dict:
    """Greedy decode on the full-width fp32 Gemma (models/text_encoder/
    generation.py): prefill and per-token seconds, the ms a token against
    the bound of reading every weight once a token (the layers and the tied
    LM head, at the card's memory rate), and the cached logits against the
    uncached forward. The decode is plain torch ops: no kernel launch."""
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.models.text_encoder.card_check import relative_error
    from ltx2_tpu_torch.models.text_encoder.gemma3 import gemma3_apply
    from ltx2_tpu_torch.models.text_encoder.generation import gemma3_generate

    gen = torch.Generator().manual_seed(SEEDS[0])
    ids = torch.randint(3, gemma.cfg.vocab_size, (1, DECODE_PROMPT), generator=gen)
    ids[0, 0] = 2  # <bos>
    mask = torch.ones_like(ids)
    _reset_counts()
    gemma3_generate(gemma, ids, mask, 2, eos_id=-1)  # warm-up
    seconds = {}
    for new in (1, DECODE_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gemma3_generate(gemma, ids, mask, new, eos_id=-1, return_logits=new == DECODE_NEW)
        torch.cuda.synchronize()
        seconds[new] = time.perf_counter() - t0
    tokens, logits = out
    counts = _counts()
    full = torch.cat([ids.to(tokens.device), tokens[:, :-1]], dim=1)
    final, _ = gemma3_apply(gemma, full, torch.ones_like(full))
    want = F.linear(final[:, -DECODE_CHECK:], gemma.embed_tokens.weight)
    got = logits[:, -DECODE_CHECK:]
    err = relative_error(got, want)
    weight_bytes = sum(p.numel() * p.element_size() for p in gemma.parameters())
    ms_token = 1000 * (seconds[DECODE_NEW] - seconds[1]) / (DECODE_NEW - 1)
    bound_ms = 1000 * weight_bytes / PEAK_BYTES_PER_S
    rec = {"prompt_tokens": DECODE_PROMPT, "new_tokens": DECODE_NEW, "prefill_s": seconds[1],
           "decode_s": seconds[DECODE_NEW], "ms_per_token": ms_token, "bound_ms_per_token": bound_ms,
           "bound_by": "bytes", "pct_of_bound": 100 * bound_ms / ms_token, "weight_gb": weight_bytes / 1e9,
           "logits_vs_uncached": err, "check_positions": DECODE_CHECK,
           "argmax_agrees": bool(torch.equal(want.argmax(-1), tokens[:, -DECODE_CHECK:])),
           "tokens_finite": bool(torch.isfinite(logits).all()), "launches": counts, "card": smi}
    del final, logits, want, got
    torch.cuda.empty_cache()
    log(f"Gemma decode (full-width fp32 Gemma-3-12B, greedy, {DECODE_NEW} tokens after {DECODE_PROMPT}): "
        f"{json.dumps(rec)}")
    if err["max_rel"] > TOL_DECODE_MAX_REL or err["rms_rel"] > TOL_DECODE_RMS_REL or not rec["tokens_finite"]:
        raise AssertionError(f"the cached decode's logits differ from the uncached forward: {err}")
    if any(counts.values()):
        raise AssertionError(f"the decode launched a kernel: {counts}")
    return rec


def _fp8_encode(gemma, enc, fp32_context, smi: str) -> dict:
    """The same Gemma quantized in memory as `load_gemma3_params(
    quantize_fp8=True)` quantizes it, then the same request encoded twice
    (the second timed): weights, peak memory, time, and the context against
    the fp32 one."""
    import torch

    from ltx2_tpu_torch.generate import encode_prompts
    from ltx2_tpu_torch.loader.fp8 import weight_bytes
    from ltx2_tpu_torch.models.text_encoder.card_check import relative_error
    from ltx2_tpu_torch.models.text_encoder.gemma3 import quantize_gemma_fp8_

    t0 = time.perf_counter()
    quantize_gemma_fp8_(gemma)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = [{"seed": SEEDS[0]}, {"seed": SEEDS[0]}]
    contexts = encode_prompts([SEEDS[0]] * 2, gemma, enc, torch.device("cuda"), stats)
    rec = {"quantize_s": quantize_s, "gemma_weight_gb": weight_bytes(gemma) / 1e9,
           "memory_gb": torch.cuda.memory_allocated() / 1e9, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "encode_s": stats[1]["text_encode_s"], "first_encode_s": stats[0]["text_encode_s"],
           "context_finite": all(s["context_finite"] for s in stats),
           "vs_fp32_context": relative_error(contexts[1], fp32_context), "card": smi}
    log(f"text encode with fp8 Gemma (quantized in memory): {json.dumps(rec)}")
    if not rec["context_finite"] or gemma.layers[0].mlp.up_proj.weight.dtype != torch.float8_e4m3fn:
        raise AssertionError(f"fp8 text encode {rec}")
    return rec


def phase_two_stage(smi: str):
    """The two-stage distilled recipe through `generate_videos_distilled`
    with text encoding at full width and depth for 2 requests of different
    seeds: frames, finite contexts and latents after each stage, the
    launches the code implies, distinct clips."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos_distilled
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs

    latent_shape = (1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32)
    tiles = len(generate_tile_specs(latent_shape, TilingConfig.default()))  # 6144 voxels > 4000: tiled
    expected = {"upscale": upscaler_convs(SpatialUpscalerConfig()),
                "decode": conv_launches(VideoDecoderConfig()) * tiles}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos_distilled(list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES,
                                              layers=LAYERS, device="cuda", text_encoder=True, phase_peaks=True)
    wall = time.perf_counter() - t0
    counts = _counts()
    phase_peaks = {k: max(s[k] for s in stats if s.get(k) is not None)
                   for k in ("text_encode_peak_gb", "stage1_peak_gb", "upscale_peak_gb", "stage2_peak_gb",
                             "decode_peak_gb")}
    peak_gb = max(phase_peaks.values())
    for s in stats:
        log(f"two-stage request seed={s['seed']}: text encode {s['text_encode_s']:.3f} s "
            f"({s['prompt_tokens']} + {s['negative_tokens']} tokens), stage 1 {s['stage1_s']:.3f} s, upscale "
            f"{s['upscale_s']:.3f} s, stage 2 {s['stage2_s']:.3f} s, decode {s['decode_s']:.3f} s "
            f"({s['decode_tiles']} tiles), attention launches {s['attention_launches']}, conv launches "
            f"{s['upscale_conv_launches']} upscale + {s['decode_conv_launches']} decode, context std "
            f"{s['context_std']:.4f} | {smi}")
    log(f"two-stage path: {len(SEEDS)} requests {WIDTH}x{HEIGHT}x{FRAMES}f (stage 1 {WIDTH // 2}x{HEIGHT // 2}), "
        f"{LAYERS} layers, text encoder on, wall {wall:.1f} s (init Gemma {stats[0]['gemma_init_s']:.1f} s, text "
        f"encoder {stats[0]['text_encoder_init_s']:.1f} s, DiT {stats[0]['dit_init_s']:.1f} s, upscaler "
        f"{stats[0]['upscaler_init_s']:.1f} s, decoder {stats[0]['decoder_init_s']:.1f} s), peak memory by phase "
        f"{json.dumps(phase_peaks)} GB, launches {counts} | {smi}")

    for f in frames:
        if f.shape != (FRAMES, HEIGHT, WIDTH, 3) or f.dtype != np.uint8:
            raise AssertionError(f"two-stage frames {f.shape} {f.dtype}")
    for s in stats:
        if not (s["context_finite"] and s["stage1_latent_finite"] and s["stage2_latent_finite"]):
            raise AssertionError(f"seed {s['seed']}: non-finite context or latent {s}")
        got = {"attention": s["attention_launches"], "upscale": s["upscale_conv_launches"],
               "decode": s["decode_conv_launches"], "tiles": s["decode_tiles"]}
        want = {"attention": TWO_STAGE_LAUNCHES_PER_CLIP, **expected, "tiles": tiles}
        if got != want:
            raise AssertionError(f"seed {s['seed']}: launches {got}, expected {want}")
    per_clip = {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0, "conv": expected["upscale"] + expected["decode"]}
    if counts != {k: v * len(SEEDS) for k, v in per_clip.items()}:
        raise AssertionError(f"two-stage launches {counts}, expected {per_clip} a clip")
    if np.array_equal(frames[0], frames[1]):
        raise AssertionError("the two two-stage requests produced identical clips")
    log(f"two-stage frames: {[f.shape for f in frames]} uint8, latent std {[s['latent_std'] for s in stats]}, "
        f"frame mean/std {[(float(f.mean()), float(f.std())) for f in frames]}, mean |clip 1 - clip 2| "
        f"{float(np.abs(frames[0].astype(np.int16) - frames[1]).mean())} levels")
    return counts, stats, phase_peaks


CKPT_DISK_GB = 24.0  # the files below take about 21 GB
GEMMA_FILE_LAYERS = 2
LORA_RANK, LORA_STRENGTH = 16, 0.8
FUSED_CHECKED = ("transformer_blocks.0.attn1.to_q.weight", "transformer_blocks.23.attn2.to_k.weight",
                 "transformer_blocks.47.ff.project_out.weight")
TOL_FP8_X0_REL = 1e-2  # kept fp8 (scale rounded to bf16 at use) vs dequantized in fp32 then bf16


def _write_checkpoints(directory: str, dev) -> dict:
    """The files of the checkpoint phase, by the port's writers: a
    full-width, full-depth V1 video DiT in the reference `-fp8` layout (E4M3
    codes, per-tensor F32 scales) with the VAE decoder, its statistics, the
    V1 text projection and video connector (for a 2-layer Gemma); the
    spatial upscaler under the v1.1 names; a 2-layer full-width bf16 Gemma-3
    in two shards under `language_model.model.`; a rank-16 LoRA of every
    block's attention and FFN linears from `export_lora_checkpoint`."""
    import os

    import torch

    from ltx2_tpu_torch.generate import make_decoder, make_dit, make_gemma, make_text_encoder, make_upscaler
    from ltx2_tpu_torch.loader.export import iter_fp8_checkpoint_specs
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors, write_safetensors_streaming
    from ltx2_tpu_torch.models.text_encoder import GEMMA3_LAYER_TYPES, Gemma3Config, TextEncoderConfig
    from ltx2_tpu_torch.models.text_encoder.encoder import text_encoder_to_checkpoint
    from ltx2_tpu_torch.models.text_encoder.gemma3 import gemma_to_checkpoint
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import upscaler_to_checkpoint
    from ltx2_tpu_torch.models.video_vae.decoder import DEFAULT_DECODER_BLOCKS
    from ltx2_tpu_torch.models.video_vae.weights import decoder_to_checkpoint
    from ltx2_tpu_torch.training.lora import add_lora_params_, export_lora_checkpoint

    paths = {"checkpoint": os.path.join(directory, "ltx-2-video-fp8.safetensors"),
             "upscaler": os.path.join(directory, "spatial-upscaler.safetensors"),
             "gemma": os.path.join(directory, "gemma"), "lora": os.path.join(directory, "lora.safetensors")}
    gen = torch.Generator(device=dev).manual_seed(41)
    decoder = make_decoder("bfloat16", dev)
    with torch.no_grad():
        decoder.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.1)
        decoder.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
    others = decoder_to_checkpoint(decoder)
    del decoder
    others.update(text_encoder_to_checkpoint(make_text_encoder(
        dev, cfg=TextEncoderConfig(num_gemma_layers=GEMMA_FILE_LAYERS + 1))))
    blocks = [["res_x", {"num_layers": b[1]}] if b[0] == "res_x" else [b[0], {"multiplier": b[1], "residual": b[2]}]
              for b in DEFAULT_DECODER_BLOCKS]
    metadata = {"model_version": "2.0.0", "config": json.dumps(
        {"transformer": {"num_attention_heads": 32, "attention_head_dim": 128}, "vae": {"decoder_blocks": blocks}})}
    dit = make_dit(LAYERS, dev, seed=42, base=LTXModelConfig(caption_channels=3840), fp8=True)
    t0 = time.perf_counter()
    write_safetensors_streaming(paths["checkpoint"], [
        *iter_fp8_checkpoint_specs(dit),
        *((k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in others.items()),
    ], metadata=metadata)
    write_s = time.perf_counter() - t0
    del others
    add_lora_params_(dit, gen, rank=LORA_RANK)
    with torch.no_grad():
        for m in dit.modules():
            if hasattr(m, "lora_B"):
                m.lora_B.normal_(generator=gen).mul_(0.02)
    export_lora_checkpoint(paths["lora"], dit)
    del dit
    torch.cuda.empty_cache()
    write_safetensors(paths["upscaler"], upscaler_to_checkpoint(make_upscaler(dev), v11=True))
    gemma = make_gemma(dev, cfg=Gemma3Config(num_hidden_layers=GEMMA_FILE_LAYERS,
                                             layer_types=GEMMA3_LAYER_TYPES[:GEMMA_FILE_LAYERS]))
    tensors = {k: v.to(torch.bfloat16) for k, v in gemma_to_checkpoint(gemma).items()}
    del gemma
    os.makedirs(paths["gemma"])
    first = {k: v for k, v in tensors.items() if "embed_tokens" in k or ".layers.0." in k}
    write_safetensors(os.path.join(paths["gemma"], "model-00001-of-00002.safetensors"), first)
    write_safetensors(os.path.join(paths["gemma"], "model-00002-of-00002.safetensors"),
                      {k: v for k, v in tensors.items() if k not in first})
    torch.cuda.empty_cache()
    sizes = {name: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(p) for f in fs)
             if os.path.isdir(p) else os.path.getsize(p) for name, p in paths.items()}
    return {"paths": paths, "gb": {k: v / 1e9 for k, v in sizes.items()}, "checkpoint_write_s": write_s}


def _timed_load(make) -> tuple:
    """(make(), seconds, peak GB above what was allocated before)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = make()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_checkpoint(smi: str) -> tuple:
    """The checkpoint layer at full width on the card: writes the files of
    `_write_checkpoints` into a fresh temporary directory (its free space
    first), loads the DiT through `ModelLedger` kept in fp8, dequantized to
    bf16, and dequantized with the LoRA fused (seconds, GB read, GB/s, peak
    memory of each); checks the kept codes and scales against the file bit
    for bit, the fused weights against the CPU's bf16(f32(bf16(f32(code) *
    scale)) + strength * B A), and one x0 forward at 6144 tokens of the kept
    fp8 model against the dequantized one; then runs 2 requests of the
    two-stage recipe from the files (`--fp8-serving`, the files' Gemma,
    `--text-encoder`). The files are deleted at the end. Returns (the
    record, the two-stage run's launches, its per-request stats)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos_distilled, make_latent_tools, make_request
    from ltx2_tpu_torch.loader.convert import fp8_e4m3_dequant
    from ltx2_tpu_torch.loader.export import inverse_rewrite
    from ltx2_tpu_torch.loader.lora import LoRAConfig, compute_lora_delta, load_lora_weights
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
    from ltx2_tpu_torch.loader.weight_loader import DIFFUSION_PREFIX, convert_checkpoint_key
    from ltx2_tpu_torch.models.text_encoder.card_check import relative_error
    from ltx2_tpu_torch.models.transformer.model import x0_model_apply
    from ltx2_tpu_torch.pipelines.common import modality_from_state
    from ltx2_tpu_torch.utils.model_ledger import ModelLedger

    dev = torch.device("cuda")
    directory = tempfile.mkdtemp(prefix="ltx2_ckpt_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    log(f"checkpoint phase: {directory} has {free_gb:.1f} GB free, the files need {CKPT_DISK_GB} GB")
    if free_gb < CKPT_DISK_GB:
        shutil.rmtree(directory, ignore_errors=True)
        raise AssertionError(f"{directory}: {free_gb:.1f} GB free, the checkpoint phase needs {CKPT_DISK_GB} GB")
    rec = {"directory_free_gb": free_gb, "card": smi}
    try:
        files = _write_checkpoints(directory, dev)
        paths = files["paths"]
        rec.update(files_gb=files["gb"], checkpoint_write_s=files["checkpoint_write_s"])
        log(f"checkpoint files written: {json.dumps(rec)}")
        f = SafetensorsFile(paths["checkpoint"])
        dit_bytes = sum(f.nbytes(k) for k in f.keys() if k.startswith(DIFFUSION_PREFIX)
                        and convert_checkpoint_key(k[len(DIFFUSION_PREFIX):]) is not None)
        loads = {}

        def load(name, ledger):
            model, seconds, peak = _timed_load(ledger.transformer)
            loads[name] = {"s": seconds, "gb_read": dit_bytes / 1e9, "gb_per_s": dit_bytes / 1e9 / seconds,
                           "peak_gb": peak, "weight_gb": sum(t.numel() * t.element_size() for t in
                                                             (*model.parameters(), *model.buffers())) / 1e9}
            log(f"DiT load ({name}): {json.dumps(loads[name])} | {smi}")
            return model

        kept = load("kept_fp8", ModelLedger(paths["checkpoint"], keep_fp8=True, device=dev))
        mismatched = []
        for name, t in (*kept.named_parameters(), *kept.named_buffers()):
            if t.dtype == torch.float8_e4m3fn or name.endswith("weight_scale"):
                written = f.get(DIFFUSION_PREFIX + inverse_rewrite(name)).to(dev)
                if not torch.equal(t.reshape(-1).view(torch.uint8), written.reshape(-1).view(torch.uint8)):
                    mismatched.append(name)
        rec["kept_tensors_checked"] = sum(1 for n, t in kept.named_parameters() if t.dtype == torch.float8_e4m3fn)
        rec["kept_mismatched"] = mismatched

        # One x0 forward at 6144 tokens: kept fp8 against dequantized bf16.
        tools = make_latent_tools(kept.cfg, HEIGHT, WIDTH, FRAMES)
        state, context = make_request(kept.cfg, tools, SEEDS[0], dev)
        video = modality_from_state(state, context, torch.tensor([0.7], device=dev), uniform_timesteps=True)
        with torch.no_grad():
            x0_kept = x0_model_apply(kept, video)
        del kept
        torch.cuda.empty_cache()
        deq = load("dequantized_bf16", ModelLedger(paths["checkpoint"], device=dev))
        with torch.no_grad():
            x0_deq = x0_model_apply(deq, video)
        rec["x0_kept_vs_dequantized"] = relative_error(x0_kept, x0_deq)
        rec["x0_finite"] = bool(torch.isfinite(x0_kept).all() and torch.isfinite(x0_deq).all())
        del deq, x0_kept, x0_deq
        torch.cuda.empty_cache()

        ledger = ModelLedger(paths["checkpoint"], keep_fp8=True, device=dev)
        fused = load("dequantized_bf16_lora_fused", ledger.with_loras([LoRAConfig(paths["lora"], LORA_STRENGTH)]))
        lora_weights = load_lora_weights(paths["lora"])
        fused_mismatch = {}
        for name in FUSED_CHECKED:
            key = DIFFUSION_PREFIX + inverse_rewrite(name)
            scale = float(f.get(key[: -len(".weight")] + ".weight_scale"))
            base = fp8_e4m3_dequant(f.get(key), scale, torch.bfloat16)  # on the CPU
            lora_base = "diffusion_model." + inverse_rewrite(name)[: -len(".weight")]
            delta = compute_lora_delta(lora_weights, lora_base + ".lora_A.weight", lora_base + ".lora_B.weight",
                                       LORA_STRENGTH, device="cpu")
            want = (base.float() + delta).to(torch.bfloat16)
            got = fused.get_parameter(name).detach().cpu()
            fused_mismatch[name] = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            if torch.equal(got, base):
                fused_mismatch[name] = -1  # the LoRA changed nothing
        rec["fused_mismatched_elements"] = fused_mismatch
        rec["loads"] = loads
        del fused
        torch.cuda.empty_cache()
        f.close()

        # The two-stage recipe from the files.
        _reset_counts()
        t0 = time.perf_counter()
        frames, stats = generate_videos_distilled(
            list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES, device="cuda", text_encoder=True,
            phase_peaks=True, ledger=ModelLedger(paths["checkpoint"], gemma_path=paths["gemma"],
                                                 spatial_upscaler_path=paths["upscaler"], keep_fp8=True,
                                                 decoder_dtype="bfloat16", device=dev))
        wall = time.perf_counter() - t0
        counts = _counts()
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    phases = ("text_encode", "stage1", "upscale", "stage2", "decode")
    rec["two_stage"] = {
        "wall_s": wall, "launches": counts,
        "init_s": {k: stats[0].get(f"{k}_init_s") for k in ("gemma", "text_encoder", "dit", "upscaler", "decoder")},
        "dit_weight_gb": stats[0]["dit_weight_gb"],
        "seconds": {p: [s[f"{p}_s"] for s in stats] for p in phases},
        "peak_gb": {p: max(s[f"{p}_peak_gb"] for s in stats if s.get(f"{p}_peak_gb") is not None) for p in phases},
        "frames": [list(v.shape) for v in frames], "card": smi,
    }
    log(f"checkpoint phase: {json.dumps(rec)}")

    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs

    if mismatched or rec["kept_tensors_checked"] != 48 * 10 + 4:
        raise AssertionError(f"kept fp8 tensors differ from the file: {mismatched[:4]}, "
                             f"{rec['kept_tensors_checked']} fp8 weights")
    if any(v != 0 for v in fused_mismatch.values()):
        raise AssertionError(f"fused weights differ from the CPU's: {fused_mismatch}")
    if not rec["x0_finite"] or rec["x0_kept_vs_dequantized"]["max_rel"] > TOL_FP8_X0_REL:
        raise AssertionError(f"x0 kept fp8 vs dequantized: {rec['x0_kept_vs_dequantized']}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32), TilingConfig.default()))
    per_clip = {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0,
                "conv": upscaler_convs(SpatialUpscalerConfig()) + conv_launches(VideoDecoderConfig()) * tiles}
    if counts != {k: v * len(SEEDS) for k, v in per_clip.items()}:
        raise AssertionError(f"two-stage from files: launches {counts}, expected {per_clip} a clip")
    for v in frames:
        if v.shape != (FRAMES, HEIGHT, WIDTH, 3) or v.dtype != np.uint8:
            raise AssertionError(f"two-stage from files: frames {v.shape} {v.dtype}")
    for st in stats:
        if not (st["context_finite"] and st["stage1_latent_finite"] and st["stage2_latent_finite"]):
            raise AssertionError(f"two-stage from files: non-finite context or latent {st}")
    if not FP8_DIT_GB[0] < stats[0]["dit_weight_gb"] < FP8_DIT_GB[1] + 0.5:
        raise AssertionError(f"the two-stage DiT from the fp8 file holds {stats[0]['dit_weight_gb']} GB")
    return rec, counts, stats


# The V2 (LTX-2.3) file phase: a prompt through a tokenizer.json the script
# writes (a small BPE with byte fallback: the card's machine has no
# `tokenizers`), the checkpoint's V2 text encoder and DiT, a .y4m out.
V2_PROMPT = "A cinematic shot of the ocean at sunset, waves on black rocks 🌅 <extra>"
V2_NEGATIVE = "worst quality, blurry"
V2_TOKENIZER_MERGES = (("▁", "a"), ("t", "h"), ("th", "e"), ("▁", "the"), ("o", "n"), ("i", "n"), ("e", "r"),
                       ("a", "t"), ("o", "c"), ("e", "a"), ("oc", "ea"), ("ocea", "n"),
                       ("▁", "ocean"), ("s", "h"), ("o", "t"), ("sh", "ot"), ("▁", "shot"), ("i", "c"),
                       ("in", "e"), ("▁", "c"), ("w", "a"), ("v", "e"), ("wa", "ve"), ("wave", "s"))
TOKENIZE_TOKENS = 1024  # the host tokenizer's timed encode: a prompt that fills the context
V2_CFG_STEPS = 2  # the one-stage and text-to-video runs from the V2 files: 2 of their 30 steps


def _write_tokenizer(directory: str) -> None:
    """tokenizer.json and tokenizer_config.json of a small BPE, as JSON:
    <pad> <eos> <bos> <unk> at Gemma's ids 0-3, the 256 <0xNN> byte tokens
    (byte fallback), ▁, letters, digits and punctuation, the merges above,
    a Replace normalizer (space -> ▁), a <bos> template and one added
    non-special token, <extra>."""
    import os

    vocab = {t: i for i, t in enumerate(["<pad>", "<eos>", "<bos>", "<unk>", "<extra>"])}
    for token in ([f"<0x{b:02X}>" for b in range(256)] + ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
                  + [chr(c) for c in range(ord("A"), ord("Z") + 1)] + list("0123456789,.'!?-")):
        vocab.setdefault(token, len(vocab))
    for a, b in V2_TOKENIZER_MERGES:
        vocab.setdefault(a + b, len(vocab))
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
              "special": t != "<extra>"} for i, t in enumerate(["<pad>", "<eos>", "<bos>", "<unk>", "<extra>"])]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}, "pre_tokenizer": None,
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}}],
                               "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
                               "special_tokens": {"<bos>": {"id": "<bos>", "ids": [2], "tokens": ["<bos>"]}}},
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": [list(m) for m in V2_TOKENIZER_MERGES]}}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
                   "pad_token": "<pad>", "unk_token": "<unk>"}, fh)


def _write_v2_files(directory: str, dev) -> dict:
    """The V2 phase's files, by the port's writers: a full-width, full-depth
    LTX-2.3 video DiT in the reference `-fp8` layout (cross-attention AdaLN,
    gated attention, prompt AdaLN, no caption projection) with the VAE
    decoder, its statistics, the V2 text projection and both gated
    connectors (8 blocks, 32 x 128 video and 32 x 64 audio, bf16 in the
    file) for a 2-layer Gemma, metadata `model_version` 2.3.0 and a V2
    config; the spatial upscaler; a 2-layer full-width bf16 Gemma-3 with
    the tokenizer's files."""
    import os

    import torch

    from ltx2_tpu_torch.generate import make_decoder, make_dit, make_gemma, make_upscaler
    from ltx2_tpu_torch.loader.export import iter_fp8_checkpoint_specs
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors, write_safetensors_streaming
    from ltx2_tpu_torch.models.text_encoder import GEMMA3_LAYER_TYPES, Gemma3Config
    from ltx2_tpu_torch.models.text_encoder.encoder import (
        VideoTextEncoder, init_text_encoder_, text_encoder_checkpoint_keys, text_encoder_config_v2,
    )
    from ltx2_tpu_torch.models.text_encoder.gemma3 import gemma_to_checkpoint
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import upscaler_to_checkpoint
    from ltx2_tpu_torch.models.video_vae.decoder import DEFAULT_DECODER_BLOCKS
    from ltx2_tpu_torch.models.video_vae.weights import decoder_to_checkpoint

    paths = {"checkpoint": os.path.join(directory, "ltx-2.3-video-fp8.safetensors"),
             "upscaler": os.path.join(directory, "spatial-upscaler.safetensors"),
             "gemma": os.path.join(directory, "gemma")}
    gen = torch.Generator(device=dev).manual_seed(51)
    decoder = make_decoder("bfloat16", dev)
    with torch.no_grad():
        decoder.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.1)
        decoder.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
    others = [(k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in decoder_to_checkpoint(decoder).items()]
    del decoder
    te = init_text_encoder_(VideoTextEncoder(text_encoder_config_v2(num_gemma_layers=GEMMA_FILE_LAYERS + 1),
                                             device=dev), gen)
    params = dict(te.named_parameters())
    others += [(key, torch.bfloat16, tuple(params[name].shape),
                (lambda t=params[name]: t.detach().to("cpu", torch.bfloat16)))
               for name, key in text_encoder_checkpoint_keys(te).items()]
    blocks = [["res_x", {"num_layers": b[1]}] if b[0] == "res_x" else [b[0], {"multiplier": b[1], "residual": b[2]}]
              for b in DEFAULT_DECODER_BLOCKS]
    metadata = {"model_version": "2.3.0", "config": json.dumps({
        "transformer": {"num_attention_heads": 32, "attention_head_dim": 128, "connector_num_attention_heads": 32,
                        "connector_attention_head_dim": 128, "audio_connector_num_attention_heads": 32,
                        "audio_connector_attention_head_dim": 64, "connector_num_layers": 8,
                        "connector_apply_gated_attention": True},
        "vae": {"decoder_blocks": blocks}})}
    dit = make_dit(LAYERS, dev, seed=52, base=LTXModelConfig(cross_attention_adaln=True, apply_gated_attention=True),
                   fp8=True)
    t0 = time.perf_counter()
    write_safetensors_streaming(paths["checkpoint"], [*iter_fp8_checkpoint_specs(dit), *others], metadata=metadata)
    write_s = time.perf_counter() - t0
    del dit, te, params, others
    torch.cuda.empty_cache()
    write_safetensors(paths["upscaler"], upscaler_to_checkpoint(make_upscaler(dev), v11=True))
    gemma = make_gemma(dev, cfg=Gemma3Config(num_hidden_layers=GEMMA_FILE_LAYERS,
                                             layer_types=GEMMA3_LAYER_TYPES[:GEMMA_FILE_LAYERS]))
    tensors = {k: v.to(torch.bfloat16) for k, v in gemma_to_checkpoint(gemma).items()}
    del gemma
    os.makedirs(paths["gemma"])
    write_safetensors(os.path.join(paths["gemma"], "model-00001-of-00001.safetensors"), tensors)
    del tensors
    _write_tokenizer(paths["gemma"])
    torch.cuda.empty_cache()
    sizes = {name: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(p) for f in fs)
             if os.path.isdir(p) else os.path.getsize(p) for name, p in paths.items()}
    return {"paths": paths, "gb": {k: v / 1e9 for k, v in sizes.items()}, "checkpoint_write_s": write_s}


def _tokenizer_host_seconds(directory: str) -> dict:
    """The host tokenizer's seconds: parsing the files (uncached), and one
    encode of a prompt of more than 1024 tokens to 1024."""
    import os

    from ltx2_tpu_torch.utils import tokenizer

    t0 = time.perf_counter()
    tok = tokenizer.Tokenizer(*(json.load(open(os.path.join(directory, name), encoding="utf-8"))
                                for name in ("tokenizer.json", "tokenizer_config.json")))
    parse_s = time.perf_counter() - t0
    long = " ".join([V2_PROMPT] * 80)
    t0 = time.perf_counter()
    ids, mask = tok([long, V2_NEGATIVE], TOKENIZE_TOKENS)
    encode_s = time.perf_counter() - t0
    if int(mask[0].sum()) != TOKENIZE_TOKENS:
        raise AssertionError(f"the long prompt took {int(mask[0].sum())} tokens, not {TOKENIZE_TOKENS}")
    return {"parse_s": parse_s, "encode_2x1024_s": encode_s, "vocab": len(tok.model.vocab),
            "merges": len(tok.model.merges)}


def phase_v2_files(smi: str) -> tuple:
    """LTX-2.3 (V2) from files on the card, through the command line a user
    calls: writes `_write_v2_files` into a fresh temporary directory (its
    free space first), then `generate.main --pipeline distilled --checkpoint
    <V2 file> --gemma-dir <Gemma + tokenizer> --spatial-upscaler <file>
    --fp8-serving --prompt ... --output <tmp>/clip.y4m --requests 2` at
    512x768x121: the prompt ids Gemma receives equal the tokenizer's on the
    CPU (byte fallback and the added token among them), the launches the code
    implies (1056 flash, 19 fp32 and 270 bf16 convs a clip), finite contexts
    and latents, two .y4m files of the header plus 121 x (6 + 3 H W) bytes,
    each phase's seconds and peaks and each component's load seconds. Then
    the same prompt and files through `--pipeline one-stage` and
    `text-to-video` at 480x704x97 for V2_CFG_STEPS steps (96 flash launches
    a step, the tiled decode's convs). The files are deleted at the end.
    Returns (the record, the two-stage run's launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.utils.tokenizer import tokenize
    from ltx2_tpu_torch.utils.video_io import y4m_header

    directory = tempfile.mkdtemp(prefix="ltx2_v2_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    log(f"V2 file phase: {directory} has {free_gb:.1f} GB free, the files need {CKPT_DISK_GB} GB")
    if free_gb < CKPT_DISK_GB:
        shutil.rmtree(directory, ignore_errors=True)
        raise AssertionError(f"{directory}: {free_gb:.1f} GB free, the V2 phase needs {CKPT_DISK_GB} GB")
    seen, apply = [], G.gemma3_apply

    def record_ids(model, ids, mask, *args, **kwargs):
        seen.append((ids.cpu(), mask.cpu()))
        return apply(model, ids, mask, *args, **kwargs)

    rec = {"directory_free_gb": free_gb, "card": smi}
    try:
        t0 = time.perf_counter()
        files = _write_v2_files(directory, torch.device("cuda"))
        paths = files["paths"]
        rec.update(files_gb=files["gb"], checkpoint_write_s=files["checkpoint_write_s"],
                   write_s=time.perf_counter() - t0, tokenizer_host=_tokenizer_host_seconds(paths["gemma"]))
        log(f"V2 files written: {json.dumps(rec)}")
        out = os.path.join(directory, "clip.y4m")
        argv = ["--pipeline", "distilled", "--checkpoint", paths["checkpoint"], "--gemma-dir", paths["gemma"],
                "--spatial-upscaler", paths["upscaler"], "--fp8-serving", "--prompt", V2_PROMPT,
                "--negative-prompt", V2_NEGATIVE, "--output", out, "--requests", str(len(SEEDS)), "--seed",
                str(SEEDS[0]), "--height", str(HEIGHT), "--width", str(WIDTH), "--num-frames", str(FRAMES),
                "--device", "cuda"]
        torch.cuda.empty_cache()
        _reset_counts()
        G.gemma3_apply = record_ids
        t0 = time.perf_counter()
        try:
            frames, stats = G.main(argv)
        finally:
            G.gemma3_apply = apply
        wall = time.perf_counter() - t0
        counts = _counts()
        want_ids, want_mask = (torch.from_numpy(a) for a in tokenize(paths["gemma"], [V2_PROMPT, V2_NEGATIVE]))
        vocab = json.load(open(os.path.join(paths["gemma"], "tokenizer.json"), encoding="utf-8"))["model"]["vocab"]
        sizes = [os.path.getsize(st["output"]) for st in stats]
        header = len(y4m_header(WIDTH, HEIGHT, 24.0))
        shapes = [(v.shape, v.dtype) for v in frames]
        distinct = not np.array_equal(frames[0], frames[1])
        del frames
        # The same prompt through the CFG flows, at the one-stage defaults' size and V2_CFG_STEPS steps.
        cfg_flows = {}
        for pipeline in ("one-stage", "text-to-video"):
            torch.cuda.empty_cache()
            _reset_counts()
            out = os.path.join(directory, f"{pipeline}.y4m")
            t0 = time.perf_counter()
            cfg_frames, cfg_stats = G.main([
                "--pipeline", pipeline, "--checkpoint", paths["checkpoint"], "--gemma-dir", paths["gemma"],
                "--fp8-serving", "--prompt", V2_PROMPT, "--negative-prompt", V2_NEGATIVE, "--output", out,
                "--seed", str(SEEDS[0]), "--height", str(ONE_STAGE["height"]), "--width", str(ONE_STAGE["width"]),
                "--num-frames", str(ONE_STAGE["frames"]), "--num-inference-steps", str(V2_CFG_STEPS),
                "--device", "cuda"])
            st = cfg_stats[0]
            cfg_flows[pipeline] = {
                "wall_s": time.perf_counter() - t0, "launches": _counts(),
                "seconds": {p: st[f"{p}_s"] for p in ("text_encode", "denoise", "decode")},
                "denoise_step_s": st["denoise_step_s"], "decode_tiles": st["decode_tiles"],
                "finite": bool(st["context_finite"] and st["denoise_latent_finite"]),
                "frames": list(cfg_frames[0].shape), "y4m_bytes": os.path.getsize(out),
                "y4m_want": len(y4m_header(ONE_STAGE["width"], ONE_STAGE["height"], 24.0))
                + ONE_STAGE["frames"] * (6 + 3 * ONE_STAGE["height"] * ONE_STAGE["width"])}
            del cfg_frames
            log(f"V2 {pipeline} from files (tokenized prompt and negative, {V2_CFG_STEPS} steps): "
                f"{json.dumps(cfg_flows[pipeline])} | {smi}")
        torch.cuda.empty_cache()
        rec["server"] = phase_server(smi, paths, directory, os.path.join(directory, "clip_0.y4m"))
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    phases = ("text_encode", "stage1", "upscale", "stage2", "decode")
    rec.update({
        "wall_s": wall, "launches": counts, "dit_weight_gb": stats[0]["dit_weight_gb"],
        "load_s": {k: stats[0].get(f"{k}_init_s") for k in ("gemma", "text_encoder", "dit", "upscaler", "decoder")},
        "seconds": {p: [s[f"{p}_s"] for s in stats] for p in phases},
        "peak_gb": {p: max(s[f"{p}_peak_gb"] for s in stats if s.get(f"{p}_peak_gb") is not None) for p in phases},
        "prompt_tokens": [stats[0]["prompt_tokens"], stats[0]["negative_tokens"]],
        "prompt_source": [s["prompt_source"] for s in stats], "y4m_bytes": sizes,
        "frames": [list(shape) for shape, _ in shapes], "cfg_flows": cfg_flows,
        "card": smi,
    })
    log(f"V2 two-stage from files (tokenized prompt, .y4m out): {json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    upscale = upscaler_convs(SpatialUpscalerConfig())
    per_clip = {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0,
                "conv": upscale + conv_launches(VideoDecoderConfig()) * tiles}
    if counts != {k: v * len(SEEDS) for k, v in per_clip.items()}:
        raise AssertionError(f"V2 two-stage from files: launches {counts}, expected {per_clip} a clip")
    if len(seen) != len(SEEDS) or any(not (torch.equal(i, want_ids) and torch.equal(m, want_mask)) for i, m in seen):
        raise AssertionError("the prompt ids Gemma received differ from the tokenizer's on the CPU")
    for token in ("<bos>", "<extra>", "<0xF0>", "▁ocean"):
        if vocab[token] not in want_ids[0].tolist():
            raise AssertionError(f"the tokenized prompt lacks {token}")
    for v in shapes:
        if v != ((FRAMES, HEIGHT, WIDTH, 3), np.uint8):
            raise AssertionError(f"V2 two-stage from files: frames {v}")
    for st in stats:
        if not (st["context_finite"] and st["stage1_latent_finite"] and st["stage2_latent_finite"]):
            raise AssertionError(f"V2 two-stage from files: non-finite context or latent {st}")
        if st["prompt_source"] != "tokenizer":
            raise AssertionError(f"V2 prompts came from {st['prompt_source']}")
    if sizes != [header + FRAMES * (6 + 3 * HEIGHT * WIDTH)] * len(SEEDS):
        raise AssertionError(f"V2 .y4m files of {sizes} bytes")
    if not distinct:
        raise AssertionError("the two V2 requests produced identical clips")
    cfg_want = {"fwd": 2 * LAYERS * V2_CFG_STEPS, "bwd": 0, "conv": conv_launches(VideoDecoderConfig()) * len(
        generate_tile_specs((1, 128, (ONE_STAGE["frames"] - 1) // 8 + 1, ONE_STAGE["height"] // 32,
                             ONE_STAGE["width"] // 32), TilingConfig.default()))}
    for pipeline, r in cfg_flows.items():
        if r["launches"] != cfg_want or not r["finite"] or r["y4m_bytes"] != r["y4m_want"]:
            raise AssertionError(f"V2 {pipeline} from files: {r}, expected launches {cfg_want}")
    if not FP8_DIT_GB[0] < stats[0]["dit_weight_gb"] < FP8_DIT_GB[1] + 0.5:
        raise AssertionError(f"the V2 DiT from the fp8 file holds {stats[0]['dit_weight_gb']} GB")
    return rec, {"fwd": counts["fwd"], "conv_fp32": upscale * len(SEEDS), "conv_bf16": counts["conv"] - upscale * len(SEEDS)}


SERVER_PROMPTS = ("A red fox runs through deep snow at dawn", "Waves break on black rocks under a low sun")
SERVER_SHORT_FRAMES = 57  # one request's num_frames


@contextlib.contextmanager
def _served(setups: list, executed: list, kept: dict):
    """While inside, every `generate.setup` (as `serve` calls it) is timed
    into `setups`, its (models, ledger) kept in `kept`, and every
    `generate.execute_request` recorded into `executed`: its seconds, peak
    GB, load seconds, stage seconds and the launches it made (the counts set
    to 0 just before it, read just after)."""
    import torch

    import ltx2_tpu_torch.generate as G

    real_setup, real_execute = G.setup, G.execute_request

    def timed_setup(args, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_setup(args, *a, **k)
        torch.cuda.synchronize()
        setups.append({"setup_s": time.perf_counter() - t0, "resident_gb": torch.cuda.memory_allocated() / 1e9,
                       "resident_weight_gb": out[0].weight_gb()})
        kept["models"] = out
        return out

    def counted_execute(args, models, ledger):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, stats = real_execute(args, models, ledger)
        torch.cuda.synchronize()
        counts = _counts()
        # The upscale phase's convs run the fp32 kernel, the decode's the bf16 one (the flows' phase counts).
        fp32 = sum(st.get("upscale_conv_launches", 0) for st in stats)
        bf16 = sum(st.get("decode_conv_launches", 0) for st in stats)
        st = stats[0]
        executed.append({
            "frames": args.frames, "skip_vae": args.skip_vae, "seconds": time.perf_counter() - t0,
            "peak_gb": max((v for k, v in st.items() if k.endswith("_peak_gb") and v is not None), default=None),
            "phase_s": {p: st.get(f"{p}_s") for p in ("text_encode", "stage1", "upscale", "stage2", "decode", "save")},
            "frames_sha256": _sha256(results[0]) if args.output.endswith(".mp4") and not args.skip_vae else None,
            "decode_tiles": st.get("decode_tiles"),
            "init_s": {k: v for k, v in st.items() if k.endswith("_init_s")},
            "fwd": counts["fwd"], "bwd": counts["bwd"], "conv_fp32": fp32, "conv_bf16": bf16,
            "conv_other": counts["conv"] - fp32 - bf16,
            "enhanced_prompt": st.get("enhanced_prompt"), "enhance_s": st.get("enhance_s"),
            "enhanced_prompt_chars": len(st.get("enhanced_prompt") or ""),
            "prompt_source": st["prompt_source"], "finite": bool(st["context_finite"] and st["stage2_latent_finite"])})
        return results, stats

    G.setup, G.execute_request = timed_setup, counted_execute
    try:
        yield
    finally:
        G.setup, G.execute_request = real_setup, real_execute


def _serve_launch(argv: list, requests: list, directory: str, name: str, setups: list, executed: list,
                  kept: dict) -> list:
    """`serve.main(argv --requests FILE)` on `requests` written as JSON
    lines (a comment line first) inside `_served`; returns the responses
    (its stdout, captured)."""
    import io
    import os

    from ltx2_tpu_torch import serve

    path = os.path.join(directory, f"{name}.jsonl")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(f"# {name}: one JSON request a line\n" + "\n".join(json.dumps(r) for r in requests) + "\n")
    out = io.StringIO()
    with _served(setups, executed, kept), contextlib.redirect_stdout(out):
        serve.main(argv + ["--requests", path])
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _http_checks(argv: list, models, ledger, request: dict) -> dict:
    """The HTTP front on 127.0.0.1, port 0, in a thread, on the launch's
    resident models: /healthz, one POST /generate and a POST without a
    Content-Length (411)."""
    import http.client
    import threading
    import urllib.request

    from ltx2_tpu_torch import generate, serve

    args = serve.build_parser().parse_args(argv + ["--http", "0"])
    generate.check_request(args)
    server = serve.make_http_server(args, models, ledger)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = resp.status
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(request).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, body = resp.status, json.loads(resp.read())
        post_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/generate")
        no_length = conn.getresponse().status
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"healthz": health, "generate": code, "status": body["status"], "post_s": post_s, "no_length": no_length,
            "artifacts": body.get("artifacts")}


@contextlib.contextmanager
def _save_parts(calls: list):
    """Times the parts of video_io's no-ffmpeg save while it is open:
    `encode_jpegs` (the JPEGs), `write_mp4_mjpeg` and `write_avi_mjpeg`
    (JPEGs and mux), `write_gif`, `np.savez` (the frames npz) and
    `_save_video_fallback` whole; appends (name, path or None, seconds)."""
    import numpy as np

    from ltx2_tpu_torch.utils import video_io as vio

    def timed(owner, name):
        real = getattr(owner, name)

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                path = args[0] if args and isinstance(args[0], str) else None
                calls.append((name, path, time.perf_counter() - t0))
        return real, call

    patched = [(owner, name) + timed(owner, name) for owner, name in
               ((vio, "encode_jpegs"), (vio, "write_mp4_mjpeg"), (vio, "write_avi_mjpeg"), (vio, "write_gif"),
                (vio, "_save_video_fallback"), (np, "savez"))]
    for owner, name, _real, call in patched:
        setattr(owner, name, call)
    try:
        yield calls
    finally:
        for owner, name, real, _call in patched:
            setattr(owner, name, real)


def _served_mp4_checks(path: str, response: dict, executed: dict, save_calls: list) -> dict:
    """A served .mp4 without ffmpeg: its artifacts (the .mp4, the GIF
    preview, the frames npz, as the JAX server lists them), the npz frames
    against the clip's hash, the first, middle and last samples of the .mp4
    against the port's JPEGs of those frames, its first 3 frames read back
    and the whole probed, the GIF's size, frame count and delay; and the
    save seconds, whole and split (`save_calls`: `_save_parts` during the
    launch; the parts whose path is this request's)."""
    import hashlib
    import os

    import numpy as np

    from ltx2_tpu_torch.utils import video_io as vio
    from ltx2_tpu_torch.utils.gif import gif_info
    from ltx2_tpu_torch.utils.jpeg import encode_jpeg

    base = path.rsplit(".", 1)[0]
    want = [path, base + ".gif", base + "_frames.npz"]
    saved = np.load(base + "_frames.npz")
    frames = saved["frames"]
    with open(path, "rb") as fh:
        data = fh.read()
    stbl = next(stbl for handler, stbl, _mdhd in vio._mov_tracks(data) if handler == b"vide")
    _fourcc, _entry, offsets, sizes, _stts = vio._mov_sample_table(data, stbl)
    picks = (0, len(frames) // 2, len(frames) - 1)
    t0 = time.perf_counter()
    read_back = vio.read_mov_mjpeg(path, HEIGHT, WIDTH, 3)
    read_s = time.perf_counter() - t0
    with open(base + ".gif", "rb") as fh:
        gif = list(gif_info(fh.read()))
    # The request's save split: each named part's seconds (the JPEGs are
    # inside write_mp4_mjpeg; mux_and_file is the rest of it).
    parts = {name: s for name, at, s in save_calls if at is None or at in want}
    parts["mux_and_file"] = parts["write_mp4_mjpeg"] - parts["encode_jpegs"]
    return {"artifacts": response.get("artifacts"), "artifacts_are_the_jax_servers": response.get("artifacts") == want,
            "npz_frames_are_the_clips": _sha256(frames) == executed["frames_sha256"] and float(saved["fps"]) == 24.0,
            "samples_are_the_encoders": all(hashlib.sha256(data[offsets[i]:offsets[i] + sizes[i]]).digest()
                                            == hashlib.sha256(encode_jpeg(frames[i])).digest() for i in picks),
            "read_back": list(read_back.shape), "read_back_finite": bool(np.isfinite(read_back).all()),
            "read_mov_mjpeg_s": read_s, "probe": list(vio.probe_mov(path)), "gif": gif,
            "bytes": {os.path.basename(p): os.path.getsize(p) for p in want}, "save_s": executed["phase_s"]["save"],
            "save_parts_s": parts}


def phase_server(smi: str, paths: dict, directory: str, reference: str) -> dict:
    """The resident server at full width (`python -m ltx2_tpu_torch.serve`'s
    `main`) on the V2 files: --pipeline distilled --fp8-serving from the
    checkpoint, Gemma, the tokenizer and the upscaler, 512x768x121, .y4m out.
    Five requests from a file: three prompts and seeds (one at num_frames
    57), an unknown field (bad_request, the server still up) and a .mp4
    output at 512x768x121 (no ffmpeg on this machine: the MJPEG .mp4, the
    GIF preview and the frames npz, as the JAX server writes them; the npz
    frames the clip's bit for bit, three of the .mp4's samples the port's
    JPEGs of them, its first frames read back through `read_mov_mjpeg`; its
    save_s). Then the HTTP front on the same
    resident models. Then a second launch with --enhance-prompt (the 2-layer
    Gemma decodes up to 512 tokens; --skip-vae). Checks: one setup a launch
    and no load seconds in any request; each request's flash, fp32-conv
    and bf16-conv launches those of a command-line clip (1056, 19 and 270
    at 121 frames); the first clip byte for byte the command line's of the
    same request (`reference`, written by `generate.main` above); the
    enhanced prompt is what the tokenizer encodes. Records setup seconds,
    resident GB, each request's seconds and peak GB."""
    import os

    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.models.text_encoder import generation
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import generate_tile_specs
    from ltx2_tpu_torch.pipelines.distilled import DistilledConfig

    launch = ["--pipeline", "distilled", "--fp8-serving", "--checkpoint", paths["checkpoint"], "--gemma-dir",
              paths["gemma"], "--spatial-upscaler", paths["upscaler"], "--negative-prompt", V2_NEGATIVE,
              "--height", str(HEIGHT), "--width", str(WIDTH), "--num-frames", str(FRAMES), "--device", "cuda"]
    outs = [os.path.join(directory, f"served_{i}.y4m") for i in range(3)]
    requests = [{"prompt": V2_PROMPT, "seed": SEEDS[0], "output": outs[0]},
                {"prompt": SERVER_PROMPTS[0], "seed": 7, "output": outs[1]},
                {"prompt": SERVER_PROMPTS[1], "seed": 8, "output": outs[2], "num_frames": SERVER_SHORT_FRAMES},
                {"prompt": V2_PROMPT, "seed": 9, "no_such_field": 1},
                {"prompt": V2_PROMPT, "seed": 9, "output": os.path.join(directory, "served.mp4")}]
    t0 = time.perf_counter()
    setups, executed, kept = [], [], {}
    with _save_parts([]) as save_calls:
        responses = _serve_launch(launch, requests, directory, "requests", setups, executed, kept)
    same_as_cli = open(outs[0], "rb").read() == open(reference, "rb").read()
    models, ledger = kept.pop("models")
    with _served([], executed, {}):
        http = _http_checks(launch, models, ledger, {"prompt": SERVER_PROMPTS[0], "seed": 11, "num_frames":
                                                     SERVER_SHORT_FRAMES, "output": os.path.join(directory, "http.y4m")})
    mp4_request = executed[3]
    http_executed = executed[4:]
    mp4 = _served_mp4_checks(os.path.join(directory, "served.mp4"), responses[4], mp4_request, save_calls)
    log(f"served .mp4 without ffmpeg (512x768x{FRAMES}: MJPEG .mp4, GIF, npz): save_s {mp4['save_s']:.2f}, parts "
        f"{json.dumps(mp4['save_parts_s'])}, bytes {json.dumps(mp4['bytes'])} | {smi}")
    del models, ledger
    gc.collect()  # the HTTP server's handler class holds the models in a reference cycle
    torch.cuda.empty_cache()
    before_enhance_gb = torch.cuda.memory_allocated() / 1e9
    served_s = time.perf_counter() - t0

    decodes, tokenized = [], []
    real_generate, real_tokenize = generation.gemma3_generate, G.tokenize_prompts

    def timed_generate(model, ids, mask, max_new_tokens, *a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens = real_generate(model, ids, mask, max_new_tokens, *a, **k)
        torch.cuda.synchronize()
        decodes.append({"prompt_tokens": int(mask.sum()), "max_new_tokens": max_new_tokens,
                        "decoded": int((tokens != k.get("pad_id", 0)).sum()), "s": time.perf_counter() - t1})
        return tokens

    def recorded_tokenize(gemma_dir, prompt, negative):
        tokenized.append(prompt)
        return real_tokenize(gemma_dir, prompt, negative)

    generation.gemma3_generate, G.tokenize_prompts = timed_generate, recorded_tokenize
    t0 = time.perf_counter()
    enh_setups, enh_executed = [], []
    try:
        enh_responses = _serve_launch(launch + ["--enhance-prompt"], [
            {"prompt": "a fox", "seed": 5, "skip_vae": True, "output": os.path.join(directory, "enhanced.y4m")}],
            directory, "enhance", enh_setups, enh_executed, {})
    finally:
        generation.gemma3_generate, G.tokenize_prompts = real_generate, real_tokenize
    gc.collect()
    torch.cuda.empty_cache()
    enhance_launch_s = time.perf_counter() - t0

    # The decode is tiled as DistilledConfig.effective_tiling decides: 6 tiles at 121 frames, none at 57.
    tilings = {f: DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=f).effective_tiling()
               for f in (FRAMES, SERVER_SHORT_FRAMES)}
    tiles = {f: len(generate_tile_specs((1, 128, (f - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32), t)) if t else 1
             for f, t in tilings.items()}
    decode_convs = conv_launches(VideoDecoderConfig())
    want = {f: {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0, "conv_fp32": upscaler_convs(SpatialUpscalerConfig()),
                "conv_bf16": decode_convs * tiles[f]} for f in tiles}
    served = executed[:3]
    rec = {"setup": setups, "requests": [{k: v for k, v in e.items() if k != "enhanced_prompt"} for e in served],
           "first_request_s": served[0]["seconds"], "steady_request_s": served[1]["seconds"],
           "responses": [{k: r.get(k) for k in ("id", "status", "kind", "seconds", "artifacts", "error")}
                         for r in responses], "served_mp4": mp4,
           "first_clip_equals_cli": same_as_cli, "http": http, "http_request": http_executed,
           "served_phase_s": served_s, "enhance_launch_s": enhance_launch_s, "enhance_setup": enh_setups,
           "allocated_before_enhance_launch_gb": before_enhance_gb,
           "enhance_request": [{k: v for k, v in e.items() if k != "enhanced_prompt"} for e in enh_executed],
           "enhanced_prompt_head": (enh_executed[0]["enhanced_prompt"] or "")[:80] if enh_executed else None,
           "enhance_decodes": decodes,
           "enhance_ms_per_token": [1000 * d["s"] / max(d["decoded"], 1) for d in decodes],
           "served_mp4_launches": {k: mp4_request[k] for k in ("fwd", "bwd", "conv_fp32", "conv_bf16")},
           "launches": {k: sum(e[k] for e in executed + enh_executed) for k in ("fwd", "bwd", "conv_fp32",
                                                                              "conv_bf16")},
           "expected_per_request": {str(f): w for f, w in want.items()}, "card": smi}
    log(f"resident server (V2 distilled fp8 from files, 512x768x{FRAMES}, JSON lines, HTTP, --enhance-prompt): "
        f"{json.dumps(rec)} | {smi}")
    if [r["status"] for r in responses] != ["ok", "ok", "ok", "error", "ok"] or \
            [r["id"] for r in responses] != list(range(5)) or responses[3].get("kind") != "bad_request":
        raise AssertionError(f"served responses {rec['responses']}")
    if not (mp4["artifacts_are_the_jax_servers"] and mp4["npz_frames_are_the_clips"] and mp4["samples_are_the_encoders"]
            and mp4["read_back"] == [1, 3, 3, HEIGHT, WIDTH] and mp4["probe"] == [24.0, FRAMES, HEIGHT, WIDTH]
            and mp4["gif"] == [WIDTH, HEIGHT, FRAMES, 40]):
        raise AssertionError(f"the served .mp4 without ffmpeg: {mp4}")
    if len(setups) != 1 or len(enh_setups) != 1 or any(v for e in executed + enh_executed for v in e["init_s"].values()):
        raise AssertionError(f"the weights loaded more than once: setups {setups}, {enh_setups}, "
                             f"requests' load seconds {[e['init_s'] for e in executed + enh_executed]}")
    for e in served + [mp4_request] + http_executed:
        got = {k: e[k] for k in ("fwd", "bwd", "conv_fp32", "conv_bf16")}
        got["conv_other"] = e["conv_other"]
        want[e["frames"]]["conv_other"] = 0
        if got != want[e["frames"]] or not e["finite"] or e["prompt_source"] != "tokenizer":
            raise AssertionError(f"a served request at {e['frames']} frames: {e}, expected {want[e['frames']]}")
    if not same_as_cli:
        raise AssertionError("the first served clip differs from generate.main's of the same request")
    if (http["healthz"], http["generate"], http["status"], http["no_length"]) != (200, 200, "ok", 411):
        raise AssertionError(f"the HTTP front: {http}")
    enh = enh_executed[0] if enh_executed else {}
    if [r["status"] for r in enh_responses] != ["ok"] or len(decodes) != 1 or decodes[0]["max_new_tokens"] != 512 \
            or tokenized != [enh.get("enhanced_prompt")]:
        raise AssertionError(f"--enhance-prompt: responses {enh_responses}, decodes {decodes}, tokenized "
                             f"{tokenized}, request {enh}")
    return rec


@contextlib.contextmanager
def _plain_kernels():
    """Every flash and conv call on its plain version while inside."""
    from ltx2_tpu_torch.models.video_vae import conv as vae_conv
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.ops.conv3d import conv3d_plain

    kernel_flash, kernel_conv = A.flash_attention, vae_conv.conv3d
    A.flash_attention = lambda q, k, v, scale=None, kv_valid=None: A.flash_attention_plain(q, k, v, scale, kv_valid)
    vae_conv.conv3d = lambda x, w, b, causal, sm, tm, w_split=None, stride=(1, 1, 1), w_valid=False: conv3d_plain(
        x, w, b, causal, sm, tm, stride, w_valid)
    try:
        yield
    finally:
        A.flash_attention, vae_conv.conv3d = kernel_flash, kernel_conv


def _frame_diff(a, b) -> dict:
    import numpy as np

    d = np.abs(a.astype(np.int16) - b)
    return {"mean_levels": float(d.mean()), "max_levels": int(d.max())}


def phase_two_stage_small(smi: str, v2: bool = False) -> dict:
    """The two-stage recipe end to end (decode included, tiled into 2 x 3 x 3
    tiles) at a small size, through the kernels, against the same pipeline
    on the same card with every flash and conv call on its plain version
    (whose agreement with the JAX package the CPU tests show): a 2-layer DiT
    of 2 x 128-wide heads (with `v2`: 2 full-width LTX-2.3 blocks, 32 x
    128, their AdaLN and prompt tables drawn non-zero, a 4096-wide context),
    a mid-16 upscaler, a base-16 bf16 decoder, 128x128x17. A run from
    another seed must fail the same limits."""
    import torch

    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import (
        VideoDecoder, VideoDecoderConfig, conv_launches, init_video_decoder_,
    )
    from ltx2_tpu_torch.models.video_vae.tiling import (
        SpatialTilingConfig, TemporalTilingConfig, TilingConfig, generate_tile_specs,
    )
    from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    if v2:
        dit = make_dit(2, dev, seed=23, base=LTXModelConfig(in_channels=16, out_channels=16,
                                                             cross_attention_adaln=True, apply_gated_attention=True))
        with torch.no_grad():
            for name, p in dit.named_parameters():
                if "scale_shift_table" in name:
                    p.normal_(generator=gen).mul_(0.3)
    else:
        dit = make_dit(2, dev, seed=22, base=LTXModelConfig(num_attention_heads=2, in_channels=16, out_channels=16,
                                                             cross_attention_dim=256))
    up_cfg = SpatialUpscalerConfig(16, 16, 1, 4)
    dec_cfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="bfloat16")
    up = init_spatial_upscaler_(SpatialUpscaler(up_cfg, device=dev), gen)
    dec = init_video_decoder_(VideoDecoder(dec_cfg, device=dev), gen)
    with torch.no_grad():
        dec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.3)
        dec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
    pipe = DistilledPipeline(dit, up, video_decoder=dec)
    context = torch.randn(1, 16, dit.cfg.cross_attention_dim, generator=gen, device=dev) * (0.5 if v2 else 0.02)
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))

    def run(seed):
        latents = {}
        config = DistilledConfig(height=128, width=128, num_frames=17, seed=seed, dtype="bfloat16",
                                 latent_channels=16, tiling_config=tiling)
        frames = pipe(context, config, callback=lambda phase, z: latents.setdefault(phase, z.float()))
        return frames, latents

    _reset_counts()
    frames_k, lat_k = run(5)
    counts = _counts()
    with _plain_kernels():
        frames_p, lat_p = run(5)
        frames_other, _ = run(6)

    rec = {"launches": counts, "frames": list(frames_k.shape),
           "latents": {k: {x: v for x, v in _mismatch(lat_k[k], lat_p[k]).items() if x != "ref_rms"} for k in lat_k},
           "frames_vs_plain": _frame_diff(frames_k, frames_p),
           "planted_other_seed": _frame_diff(frames_other, frames_p),
           "tol_latent_rms_rel": TOL_SMALL_LATENT_RMS_REL, "tol_mean_levels": TOL_SMALL_MEAN_LEVELS}
    log(f"{'V2 ' if v2 else ''}two-stage small-input check (kernels vs plain on the card): {json.dumps(rec)} | {smi}")
    del pipe, dit, up, dec
    torch.cuda.empty_cache()
    # 8 + 3 steps x 2 layers x (self + cross attention); the upscaler's convs
    # and 45 a decoder call, one call a tile.
    tiles = len(generate_tile_specs((1, 16, 3, 4, 4), tiling))
    want = {"fwd": 2 * 2 * (8 + 3), "bwd": 0,
            "conv": upscaler_convs(up_cfg) + conv_launches(dec_cfg) * tiles}
    if counts != want:
        raise AssertionError(f"small two-stage launches {counts}, expected {want}")
    if frames_k.shape != (17, 128, 128, 3) or any(not r["finite"] for r in rec["latents"].values()):
        raise AssertionError(f"small two-stage output {rec}")
    if any(r["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL for r in rec["latents"].values()):
        raise AssertionError(f"small two-stage latents disagree with the plain path: {rec['latents']}")
    if rec["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"small two-stage frames disagree with the plain path: {rec['frames_vs_plain']}")
    if rec["planted_other_seed"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"the small two-stage check accepts another seed's clip: {rec}")
    return rec


# The audio-video path (LTX-2.0, V1): the AV DiT at full width, 32 x 128
# video and 32 x 64 audio heads, kept in fp8; 121 frames at 24 fps give 126
# audio latent frames, 501 mel frames, 120240 samples at 24 kHz. Its depth
# for the two-stage clips, a2vid and the traced steps, cut from 48 for the
# whole script's time since the data-parallel training phase.
AV_TWO_STAGE_LAYERS = 24
AV_AUDIO_TOKENS = 126
AV_WAV_SAMPLES = {24000: (4 * AV_AUDIO_TOKENS - 3) * 240, 48000: 2 * (4 * AV_AUDIO_TOKENS - 3) * 240}
# Flash launches an AV block makes a step, by head dim: video self and text
# cross-attention at 128; audio self, audio text, audio->video and
# video->audio at 64.
AV_FLASH_PER_BLOCK = {64: 4, 128: 2}
# The AV small check (kernels against plain): the two-stage small check's
# limits, the audio latents held to the latents' rms limit.
AV_SMALL = {"layers": 2, "height": 128, "width": 128, "frames": 17}


def _av_flash(layers: int, steps: int, clips: int) -> dict:
    """{head dim: flash launches} of `clips` AV clips of `steps` steps."""
    return {d: n * layers * steps * clips for d, n in AV_FLASH_PER_BLOCK.items()}


def _wav_header(path: str) -> dict:
    import wave

    with wave.open(path) as w:
        return {"channels": w.getnchannels(), "rate": w.getframerate(), "samples": w.getnframes(),
                "sample_bytes": w.getsampwidth()}


def phase_av_two_stage(smi: str) -> tuple:
    """The audio-video two-stage recipe at full width and depth through the
    Python entry `generate_videos_distilled(audio=True)` (the CLI's
    `--pipeline distilled --audio`): the random V1 AV DiT kept in fp8, dummy
    contexts, 512x768x121 (6144 video and 126 audio tokens in stage 2, 1536
    and 126 in stage 1), 2 requests, each written by `save_video` as a .y4m
    with its .wav; each phase's seconds and peaks (an audio-decode phase
    beside the video decode, the published audio decoder and vocoder),
    flash launches by head dim against 6 an AV block a step, the .wav
    headers. Then one traced AV step at 6144 tokens (profile_slice) beside
    phase 5's video-only fp8 step, one at stage 1's 1536, audio-to-video on
    the same DiT (`phase_a2vid`) and one traced audio decode.
    Returns (the record, the launches, a2vid's record, a2vid's launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.profile_slice import audio_decode, av_denoise_step
    from ltx2_tpu_torch.utils.video_io import save_video, y4m_header

    dev, card = torch.device("cuda"), torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit = G.make_dit(AV_TWO_STAGE_LAYERS, dev, base=G.av_config(), fp8=True)
    init_s = time.perf_counter() - t0
    _reset_counts()
    flash_attention.launches_by_head_dim = {}
    t0 = time.perf_counter()
    results, stats = G.generate_videos_distilled(list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES,
                                                 device="cuda", dit=dit, phase_peaks=True, audio=True)
    wall = time.perf_counter() - t0
    counts, by_dim = _counts(), dict(flash_attention.launches_by_head_dim)
    directory = tempfile.mkdtemp(prefix="ltx2_av_")
    try:
        files = []
        for i, ((frames, wave), st) in enumerate(zip(results, stats)):
            path = os.path.join(directory, f"clip_{i}.y4m")
            save_video(frames, path, 24.0, audio=wave, audio_sample_rate=st["audio_sample_rate"])
            files.append({"y4m_bytes": os.path.getsize(path), "wav": _wav_header(path[:-4] + ".wav")})
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    distinct = not np.array_equal(results[0][1], results[1][1])
    shapes = [(list(f.shape), list(w.shape)) for f, w in results]
    del results
    torch.cuda.empty_cache()
    with torch.no_grad():
        audio_latent, step = av_denoise_step(dit, HEIGHT, WIDTH, "av_denoise_step", dev, card)
        stage1_step = av_denoise_step(dit, HEIGHT // 2, WIDTH // 2, "av_stage1_step", dev, card)[1]
    torch.cuda.empty_cache()
    a2vid, a2vid_counts = phase_a2vid(smi, dit)
    del dit
    torch.cuda.empty_cache()
    with torch.no_grad():
        decode = audio_decode(audio_latent, dev, card)
    torch.cuda.empty_cache()

    phases = ("stage1", "upscale", "stage2", "decode", "audio_decode")
    rec = {"dit_init_s": init_s, "wall_s": wall, "dit_weight_gb": stats[0]["dit_weight_gb"], "launches": counts,
           "flash_by_head_dim": by_dim, "seconds": {p: [s[f"{p}_s"] for s in stats] for p in phases},
           "peak_gb": {p: max(s[f"{p}_peak_gb"] for s in stats) for p in phases}, "files": files,
           "shapes": shapes, "audio_init_s": {k: stats[0].get(f"{k}_init_s") for k in ("audio_decoder", "vocoder")},
           **{name: {k: r[k] for k in ("tokens", "audio_tokens", "device_ms", "wall_ms", "busy_share",
                                       "device_ms_by_class")} for name, r in (("av_step", step),
                                                                              ("av_stage1_step", stage1_step))},
           "audio_decode_traced": {k: decode[k] for k in ("device_ms", "wall_ms", "busy_share",
                                                          "device_ms_by_class")},
           "card": smi}
    log(f"AV two-stage (V1, {AV_TWO_STAGE_LAYERS} fp8 blocks, 512x768x121 + 126 audio tokens, .y4m + .wav): "
        f"{json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    upscale = upscaler_convs(SpatialUpscalerConfig())
    want_dim = _av_flash(AV_TWO_STAGE_LAYERS, 8 + 3, len(SEEDS))
    want = {"fwd": sum(want_dim.values()), "bwd": 0,
            "conv": (upscale + conv_launches(VideoDecoderConfig()) * tiles) * len(SEEDS)}
    if counts != want or by_dim != want_dim:
        raise AssertionError(f"AV two-stage launches {counts} {by_dim}, expected {want} {want_dim}")
    header = len(y4m_header(WIDTH, HEIGHT, 24.0)) + FRAMES * (6 + 3 * HEIGHT * WIDTH)
    wav = {"channels": 2, "rate": 24000, "samples": AV_WAV_SAMPLES[24000], "sample_bytes": 2}
    for f, st in zip(files, stats):
        if f != {"y4m_bytes": header, "wav": wav}:
            raise AssertionError(f"AV files {f}, expected {header} y4m bytes and {wav}")
        if not (st["stage1_latent_finite"] and st["stage2_latent_finite"] and st["audio_finite"]):
            raise AssertionError(f"AV two-stage: non-finite output {st}")
    if not distinct:
        raise AssertionError("the two AV requests produced identical audio")
    return rec, {"fwd": counts["fwd"], "fwd_by_head_dim": by_dim, "conv_fp32": upscale * len(SEEDS),
                 "conv_bf16": counts["conv"] - upscale * len(SEEDS)}, a2vid, a2vid_counts


def phase_audio_decode_check(smi: str) -> dict:
    """The published audio decoder, LTX-2's vocoder and an LTX-2.3-shaped
    BWE chain on the card against the CPU (models/audio_vae/card_check.py):
    relative rms 1e-5, TF32 off; no kernel launches (the JAX package runs
    these convs outside Pallas)."""
    from ltx2_tpu_torch.models.audio_vae.card_check import audio_against_cpu

    _reset_counts()
    rec = audio_against_cpu()
    rec["launches"] = _counts()
    rec["card"] = smi
    log(f"audio decoder and vocoders, card vs CPU: {json.dumps(rec)}")
    if not rec["ok"] or any(rec["launches"].values()):
        raise AssertionError(f"audio decode on the card disagrees with the CPU: {rec}")
    return rec


def phase_av_small(smi: str) -> dict:
    """The AV two-stage recipe end to end (tiled video decode, audio decode)
    at a small size through the kernels against the same pipeline with every
    flash and conv call on its plain version: 2 full-width AV blocks (32 x
    128 video and 32 x 64 audio heads, AdaLN and cross-modal tables drawn
    non-zero), a mid-16 upscaler, a base-16 bf16 decoder, a small audio
    decoder and vocoder, 128x128x17 (18 audio tokens). The video frames and
    the video and audio latents are held to the two-stage small check's
    limits (the waveform is recorded); a run from another seed must fail
    them."""
    import torch

    from ltx2_tpu_torch.generate import av_config, make_dit
    from ltx2_tpu_torch.models.audio_vae import (
        AudioDecoder, AudioDecoderConfig, Vocoder, VocoderConfig, init_audio_decoder_, init_vocoder_,
    )
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig, init_video_decoder_
    from ltx2_tpu_torch.models.video_vae.tiling import SpatialTilingConfig, TemporalTilingConfig, TilingConfig
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.pipelines.common import decode_audio, decode_video
    from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline, stage_seeds

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    dit = make_dit(AV_SMALL["layers"], dev, seed=32, base=av_config(LTXModelConfig(in_channels=16, out_channels=16)))
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    up = init_spatial_upscaler_(SpatialUpscaler(SpatialUpscalerConfig(16, 16, 1, 4), device=dev), gen)
    dec = init_video_decoder_(VideoDecoder(VideoDecoderConfig(base_channels=16, latent_channels=16,
                                                              compute_dtype="bfloat16"), device=dev), gen)
    adec = init_audio_decoder_(AudioDecoder(AudioDecoderConfig(ch=16, num_res_blocks=1), device=dev), gen)
    voc = init_vocoder_(Vocoder(VocoderConfig(upsample_initial_channel=64), device=dev), gen)
    pipe = DistilledPipeline(dit, up, video_decoder=dec)
    context = torch.randn(1, 16, dit.cfg.cross_attention_dim, generator=gen, device=dev) * 0.5
    audio_context = torch.randn(1, 16, dit.cfg.audio_inner_dim, generator=gen, device=dev) * 0.5
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))

    def run(seed):
        """The recipe's latents, then its two decodes as the pipeline runs them."""
        latents = {}
        config = DistilledConfig(height=AV_SMALL["height"], width=AV_SMALL["width"], num_frames=AV_SMALL["frames"],
                                 seed=seed, dtype="bfloat16", latent_channels=16, tiling_config=tiling,
                                 audio_enabled=True)
        latent, audio_latent = pipe(context, config, audio_encoding=audio_context, skip_decode=True,
                                    callback=lambda phase, z: latents.setdefault(phase, z.float()))
        frames = decode_video(latent, dec, tiling, stage_seeds(seed)[2])
        return frames, decode_audio(audio_latent, adec, voc), latents, audio_latent.float()

    _reset_counts()
    flash_attention.launches_by_head_dim = {}
    frames_k, wave_k, lat_k, audio_k = run(5)
    counts, by_dim = _counts(), dict(flash_attention.launches_by_head_dim)
    with _plain_kernels():
        frames_p, wave_p, lat_p, audio_p = run(5)
        frames_o, _, _, audio_o = run(6)

    def err(a, b):
        return {x: v for x, v in _mismatch(a, b).items() if x != "ref_rms"}

    rec = {"flash_by_head_dim": by_dim, "frames": list(frames_k.shape), "waveform": list(wave_k.shape),
           "latents": {k: err(lat_k[k], lat_p[k]) for k in ("stage1", "upscale", "stage2")},
           "audio_latent": err(audio_k, audio_p), "waveform_vs_plain": err(wave_k, wave_p),
           "frames_vs_plain": _frame_diff(frames_k, frames_p),
           "planted_other_seed": {"frames": _frame_diff(frames_o, frames_p), "audio_latent": err(audio_o, audio_p)},
           "tol_latent_rms_rel": TOL_SMALL_LATENT_RMS_REL, "tol_mean_levels": TOL_SMALL_MEAN_LEVELS, "card": smi}
    log(f"AV two-stage small-input check (kernels vs plain on the card): {json.dumps(rec)}")
    del pipe, dit, up, dec, adec, voc
    torch.cuda.empty_cache()
    want = _av_flash(AV_SMALL["layers"], 8 + 3, 1)
    if by_dim != want:
        raise AssertionError(f"AV small check: flash launches by head dim {by_dim}, expected {want}")
    checked = list(rec["latents"].values()) + [rec["audio_latent"]]
    if not all(r["finite"] for r in checked) or any(r["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL for r in checked):
        raise AssertionError(f"AV small check: latents disagree with the plain path: {rec}")
    if rec["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"AV small check: frames disagree with the plain path: {rec['frames_vs_plain']}")
    other = rec["planted_other_seed"]
    if other["frames"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS or other["audio_latent"]["rms_rel_err"] <= \
            TOL_SMALL_LATENT_RMS_REL:
        raise AssertionError(f"the AV small check accepts another seed's clip: {other}")
    return rec


# The two-stage CFG pipeline and audio-to-video: stage 1
# of two-stage runs the multi-modal loop's three rows (cond, uncond,
# modality-isolated) at batch 3 over 8 steps (30 in the reference's
# configuration: a cut); stage 2 the distilled 3-sigma tail at batch 1;
# a2vid is the distilled recipe (8 + 3 steps at batch 1) with the audio
# latent frozen. 6 flash launches an AV block a step either way.
TWO_STAGE_CFG_STEPS = 8
# The phase's AV DiT depth, cut from 48 for the whole script's time (to 24
# first, to 12 since the data-parallel training phase).
TWO_STAGE_CFG_LAYERS = 12
TWO_STAGE_CFG = {"cfg_scale": 3.0, "audio_cfg_scale": 7.0, "modality_scale": 3.0, "rescale_scale": 0.7}
# The distilled LoRA: random, rank 384 (the published ltx-2-19b-distilled-lora-384's) on every linear of
# every block, bf16 in its file; A ~ N(0, 1 / in), B ~ N(0, 0.003^2): deltas about a tenth of the weights.
DISTILLED_LORA_RANK, DISTILLED_LORA_B_STD = 384, 0.003
# a2vid's source: 16-bit stereo PCM at 44.1 kHz, longer than the clip (121 / 24 s), so that the loader
# cuts it and resamples it to 16 kHz by picking samples.
A2VID_SOURCE_RATE, A2VID_SOURCE_SECONDS = 44100, 6.0
# One bf16 rounding step at magnitude x is 2^(floor(log2 x) - 7): fuse and unfuse round once each, so
# |unfused - original| <= one step at the larger of the fused and unfused magnitudes (fp32's own rounding
# of the sum and the difference adds at most 2^-16 of a step).
TOL_LORA_DRIFT_STEPS = 1.0 + 2.0 ** -10


def _two_stage_flash(layers: int, clips: int) -> dict:
    """{"by_head_dim", "by_batch"} flash launches of `clips` two-stage CFG
    (or a2vid, all at batch 1) clips."""
    steps = TWO_STAGE_CFG_STEPS + 3
    per_step = sum(AV_FLASH_PER_BLOCK.values()) * layers
    return {"by_head_dim": _av_flash(layers, steps, clips),
            "by_batch": {3: per_step * TWO_STAGE_CFG_STEPS * clips, 1: per_step * 3 * clips}}


def _a2vid_samples() -> int:
    """The samples the loader keeps: the clip's seconds of the source at
    44.1 kHz, then int(n x 16000 / 44100) picked."""
    return int(int(FRAMES / 24.0 * A2VID_SOURCE_RATE) * 16000 / A2VID_SOURCE_RATE)


def _write_source_wav(path: str) -> None:
    import wave

    import numpy as np

    rng = np.random.default_rng(7)
    n = int(A2VID_SOURCE_SECONDS * A2VID_SOURCE_RATE)
    t_s = np.arange(n) / A2VID_SOURCE_RATE
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t_s) * (1 + 0.5 * np.sin(2 * np.pi * 0.5 * t_s))
    pcm = np.stack([tone, np.roll(tone, 441)]) + 0.05 * rng.standard_normal((2, n))
    with wave.open(path, "w") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(A2VID_SOURCE_RATE)
        w.writeframes((np.clip(pcm, -1, 1).T * 32767).astype(np.int16).tobytes())


def _flash_by(counter: str) -> dict:
    from ltx2_tpu_torch.ops.attention import flash_attention

    return dict(getattr(flash_attention, counter))


def _reset_flash_by() -> None:
    from ltx2_tpu_torch.ops.attention import flash_attention

    flash_attention.launches_by_head_dim, flash_attention.launches_by_batch = {}, {}


def phase_a2vid(smi: str, dit) -> tuple:
    """Audio-to-video at full width and depth through `generate_videos_a2vid`
    (the CLI's `--pipeline a2vid --audio --audio-file`) on the fp8 AV DiT of
    the AV two-stage phase: a 16-bit stereo .wav written at 44.1 kHz, the
    audio encoder at its published widths with random weights written to a
    file and read back through `ModelLedger.audio_encoder`, 512x768x121, 2
    requests, each written as a .y4m with its .wav; checks the frozen audio
    latent bit for bit after each stage, the frames, the finite latents, the
    .wav (16 kHz, 2 x 16-bit, the loader's samples) and the launches.
    Returns (the record, the launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors
    from ltx2_tpu_torch.models.audio_vae.weights import audio_encoder_to_checkpoint
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.utils.model_ledger import ModelLedger
    from ltx2_tpu_torch.utils.video_io import save_video, y4m_header

    dev = torch.device("cuda")
    directory = tempfile.mkdtemp(prefix="ltx2_a2vid_")
    try:
        source = os.path.join(directory, "source.wav")
        _write_source_wav(source)
        enc_path = os.path.join(directory, "audio_encoder.safetensors")
        t0 = time.perf_counter()
        write_safetensors(enc_path, audio_encoder_to_checkpoint(G.make_audio_encoder(dev)))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        encoder = ModelLedger(enc_path, device="cuda").audio_encoder()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        _reset_counts()
        _reset_flash_by()
        t0 = time.perf_counter()
        results, stats = G.generate_videos_a2vid(list(SEEDS), audio_file=source, height=HEIGHT, width=WIDTH,
                                                 frames=FRAMES, device="cuda", dit=dit, audio_encoder=encoder,
                                                 phase_peaks=True, audio=True)
        wall = time.perf_counter() - t0
        counts, by_dim, by_batch = _counts(), _flash_by("launches_by_head_dim"), _flash_by("launches_by_batch")
        files = []
        for i, ((frames, wave), st) in enumerate(zip(results, stats)):
            path = os.path.join(directory, f"clip_{i}.y4m")
            save_video(frames, path, 24.0, audio=wave, audio_sample_rate=st["audio_sample_rate"])
            files.append({"y4m_bytes": os.path.getsize(path), "wav": _wav_header(path[:-4] + ".wav")})
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    distinct = not np.array_equal(results[0][0], results[1][0])
    shapes = [(list(f.shape), list(w.shape)) for f, w in results]
    del results, encoder
    torch.cuda.empty_cache()

    phases = ("audio_encode", "stage1", "upscale", "stage2", "decode")
    rec = {"wall_s": wall, "encoder_write_s": write_s, "encoder_load_s": load_s,
           "audio_load_s": stats[0].get("audio_load_s"), "launches": counts, "flash_by_head_dim": by_dim,
           "flash_by_batch": by_batch, "seconds": {p: [s[f"{p}_s"] for s in stats] for p in phases},
           "peak_gb": {p: max(s[f"{p}_peak_gb"] for s in stats) for p in phases},
           "frozen_by_stage": [s["audio_frozen_by_stage"] for s in stats], "files": files, "shapes": shapes,
           "card": smi}
    log(f"a2vid ({AV_TWO_STAGE_LAYERS} fp8 AV blocks, 512x768x121, frozen encoded audio, 16 kHz .wav): "
        f"{json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    upscale = upscaler_convs(SpatialUpscalerConfig())
    want_dim = _av_flash(AV_TWO_STAGE_LAYERS, 8 + 3, len(SEEDS))
    want = {"fwd": sum(want_dim.values()), "bwd": 0,
            "conv": (upscale + conv_launches(VideoDecoderConfig()) * tiles) * len(SEEDS)}
    if counts != want or by_dim != want_dim or by_batch != {1: want["fwd"]}:
        raise AssertionError(f"a2vid launches {counts} {by_dim} {by_batch}, expected {want} {want_dim}")
    header = len(y4m_header(WIDTH, HEIGHT, 24.0)) + FRAMES * (6 + 3 * HEIGHT * WIDTH)
    wav = {"channels": 2, "rate": 16000, "samples": _a2vid_samples(), "sample_bytes": 2}
    for f, st in zip(files, stats):
        if f != {"y4m_bytes": header, "wav": wav}:
            raise AssertionError(f"a2vid files {f}, expected {header} y4m bytes and {wav}")
        if st["audio_frozen_by_stage"] != [True, True]:
            raise AssertionError(f"a2vid: the frozen audio latent moved: {st['audio_frozen_by_stage']}")
        if not (st["stage1_latent_finite"] and st["stage2_latent_finite"] and st["audio_encode_latent_finite"]):
            raise AssertionError(f"a2vid: non-finite latent {st}")
    if not distinct:
        raise AssertionError("the two a2vid requests produced identical clips")
    return rec, {"fwd": counts["fwd"], "fwd_by_head_dim": by_dim, "conv_fp32": upscale * len(SEEDS),
                 "conv_bf16": counts["conv"] - upscale * len(SEEDS)}


def _write_distilled_lora(path: str, dit, rank: int = DISTILLED_LORA_RANK, keep=None) -> dict:
    """A random LoRA of `rank` (default 384) on every linear of every block
    of `dit` (a module, or one on `meta`: only the shapes are read), or on
    those whose name `keep` accepts, bf16, drawn on the card tensor by
    tensor and streamed to `path`."""
    import torch

    from ltx2_tpu_torch.loader.export import inverse_rewrite
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors_streaming

    gen = torch.Generator(device="cuda").manual_seed(44)
    specs = []

    def draw(shape, std):
        return lambda: (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16).cpu()

    for name, p in dit.named_parameters():
        if (name.startswith("transformer_blocks.") and name.endswith(".weight") and p.ndim == 2
                and (keep is None or keep(name))):
            base = "diffusion_model." + inverse_rewrite(name)[: -len(".weight")]
            out_f, in_f = p.shape
            specs.append((f"{base}.lora_A.weight", torch.bfloat16, (rank, in_f),
                          draw((rank, in_f), in_f ** -0.5)))
            specs.append((f"{base}.lora_B.weight", torch.bfloat16, (out_f, rank),
                          draw((out_f, rank), DISTILLED_LORA_B_STD)))
    write_safetensors_streaming(path, specs)
    return {"targets": len(specs) // 2, "weights": sum(math.prod(s[2]) for s in specs)}


def _lora_drift(dit, applied: dict, seed: int = 0) -> dict:
    """The fuse-then-unfuse drift of every fused weight in bf16 rounding
    steps: |unfused - original| / 2^(floor(log2 max(|fused|, |unfused|)) - 7),
    the original weights drawn again on the card, linear by linear, from
    make_dit's generator at `seed` in its order (init_ltx_model_), the
    fused ones made again from the original and the LoRA's terms as the
    fuse made them; every weight the LoRA does not touch, and every bias,
    must equal its draw bit for bit (which also proves the draws are
    make_dit's). Returns the largest drift, the weights that moved, the
    largest absolute drift, the weights checked and the untouched ones'
    equality."""
    import torch

    from ltx2_tpu_torch.loader.lora import _delta
    from ltx2_tpu_torch.ops.common import Linear

    gen = torch.Generator(device=next(dit.parameters()).device).manual_seed(seed)
    names = {id(p): n for n, p in dit.named_parameters()}
    worst, moved, total, worst_abs, tensors, untouched_equal = 0.0, 0, 0, 0.0, 0, True
    for m in dit.modules():
        if not isinstance(m, Linear):
            continue
        bound = 1.0 / (m.weight.shape[1] ** 0.5)
        original = torch.empty_like(m.weight).uniform_(-bound, bound, generator=gen)
        if m.bias is not None:
            untouched_equal &= torch.equal(torch.empty_like(m.bias).uniform_(-bound, bound, generator=gen), m.bias)
        name = names[id(m.weight)]
        if name not in applied:
            untouched_equal &= torch.equal(original, m.weight)
            continue
        fused = original
        for terms in applied[name]:  # one rounding per alias, as the fuse
            fused = (fused.float() + _delta(terms, original.device)).to(original.dtype)
        unfused = m.weight.float()
        mag = torch.maximum(fused.float().abs(), unfused.abs())
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        diff = (unfused - original.float()).abs()
        worst = max(worst, float((diff / step).max()))
        worst_abs = max(worst_abs, float(diff.max()))
        moved += int((diff > 0).sum())
        total += diff.numel()
        tensors += 1
    return {"max_steps": worst, "max_abs": worst_abs, "moved": moved, "weights": total, "tensors": tensors,
            "untouched_equal": bool(untouched_equal), "tol_steps": TOL_LORA_DRIFT_STEPS}


def phase_two_stage_cfg(smi: str) -> tuple:
    """The two-stage CFG pipeline at full width and TWO_STAGE_CFG_LAYERS
    blocks through `generate_videos_two_stage` (the CLI's `--pipeline
    two-stage --audio --distilled-lora`): the random V1 AV DiT in bf16 (a LoRA cannot be
    fused into fp8 weights), 512x768x121, 2 requests: stage 1 at 256x384 on
    8 LTX2Scheduler steps (cut from 30) under the multi-modal guider (CFG
    3.0, audio CFG 7.0, modality 3.0, rescale 0.7: rows at batch 3), the
    fp32 upscaler, a random rank-384 distilled LoRA on every block linear
    fused for the 3-sigma stage 2 and unfused after it, the tiled decode
    and the audio decode; each written as a .y4m with its .wav. Checks the
    frames, finite latents, the .wav, the launches by head dim and batch,
    and after the first request's unfuse every fused weight within one bf16
    rounding step of its original (drawn again from make_dit's generator;
    every other weight equal to its draw). Then one traced 3-row
    stage-1 step beside the 1-row AV step at 1536 tokens (profile_slice).
    Returns (the record, the launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.loader.lora import LoRAConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.pipelines import two_stage
    from ltx2_tpu_torch.profile_slice import av_denoise_step
    from ltx2_tpu_torch.utils.video_io import save_video, y4m_header

    dev, card = torch.device("cuda"), torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit = G.make_dit(TWO_STAGE_CFG_LAYERS, dev, base=G.av_config())
    init_s = time.perf_counter() - t0
    directory = tempfile.mkdtemp(prefix="ltx2_two_stage_cfg_")
    fuse, unfuse = two_stage.fuse_lora_into_params, two_stage.unfuse_lora_deltas
    drift, calls = {}, {"fuse_s": [], "unfuse_s": []}
    try:
        lora_path = os.path.join(directory, "distilled_lora.safetensors")
        t0 = time.perf_counter()
        lora_info = _write_distilled_lora(lora_path, dit)
        lora_info.update(write_s=time.perf_counter() - t0, file_gb=os.path.getsize(lora_path) / 1e9)
        target_weights = sum(p.numel() for n, p in dit.named_parameters()
                             if n.startswith("transformer_blocks.") and n.endswith(".weight") and p.ndim == 2)

        def fuse_recorded(model, configs, return_deltas=False):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fuse(model, configs, return_deltas=return_deltas)
            torch.cuda.synchronize()
            calls["fuse_s"].append(time.perf_counter() - t1)
            return out

        def unfuse_checked(model, applied):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = unfuse(model, applied)
            torch.cuda.synchronize()
            calls["unfuse_s"].append(time.perf_counter() - t1)
            if not drift:  # the first request's unfuse against the original weights (in its phase's time)
                t1 = time.perf_counter()
                drift.update(_lora_drift(model, applied))
                drift["check_s"] = time.perf_counter() - t1
            return out

        two_stage.fuse_lora_into_params, two_stage.unfuse_lora_deltas = fuse_recorded, unfuse_checked
        _reset_counts()
        _reset_flash_by()
        t0 = time.perf_counter()
        results, stats = G.generate_videos_two_stage(
            list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES, steps=TWO_STAGE_CFG_STEPS, device="cuda",
            dit=dit, distilled_lora=LoRAConfig(lora_path), phase_peaks=True, audio=True, **TWO_STAGE_CFG)
        wall = time.perf_counter() - t0
        counts, by_dim, by_batch = _counts(), _flash_by("launches_by_head_dim"), _flash_by("launches_by_batch")
        two_stage.fuse_lora_into_params, two_stage.unfuse_lora_deltas = fuse, unfuse
        files = []
        for i, ((frames, wave), st) in enumerate(zip(results, stats)):
            path = os.path.join(directory, f"clip_{i}.y4m")
            save_video(frames, path, 24.0, audio=wave, audio_sample_rate=st["audio_sample_rate"])
            files.append({"y4m_bytes": os.path.getsize(path), "wav": _wav_header(path[:-4] + ".wav")})
    finally:
        two_stage.fuse_lora_into_params, two_stage.unfuse_lora_deltas = fuse, unfuse
        shutil.rmtree(directory, ignore_errors=True)
    distinct = not np.array_equal(results[0][0], results[1][0])
    shapes = [(list(f.shape), list(w.shape)) for f, w in results]
    del results
    torch.cuda.empty_cache()
    with torch.no_grad():
        one_row = av_denoise_step(dit, HEIGHT // 2, WIDTH // 2, "av_stage1_step_bf16", dev, card)[1]
        three_rows = av_denoise_step(dit, HEIGHT // 2, WIDTH // 2, "mm_stage1_step_bf16", dev, card,
                                     multimodal=True)[1]
    del dit
    torch.cuda.empty_cache()

    phases = ("stage1", "upscale", "lora_fuse", "stage2", "lora_unfuse", "decode", "audio_decode")
    traced = ("rows", "tokens", "audio_tokens", "device_ms", "wall_ms", "busy_share", "device_ms_by_class")
    rec = {"dit_init_s": init_s, "wall_s": wall, "dit_weight_gb": stats[0]["dit_weight_gb"], "lora": lora_info,
           "lora_drift_first_request": drift, "lora_calls": calls, "launches": counts,
           "flash_by_head_dim": by_dim, "flash_by_batch": by_batch,
           "seconds": {p: [s[f"{p}_s"] for s in stats] for p in phases},
           "stage1_step_s": [s["stage1_step_s"] for s in stats],
           "peak_gb": {p: max(s[f"{p}_peak_gb"] for s in stats) for p in phases}, "files": files, "shapes": shapes,
           "steps_stage1": TWO_STAGE_CFG_STEPS, **TWO_STAGE_CFG,
           "stage1_step_1_row": {k: one_row[k] for k in traced},
           "stage1_step_3_rows": {k: three_rows[k] for k in traced}, "card": smi}
    log(f"two-stage CFG ({TWO_STAGE_CFG_LAYERS} bf16 AV blocks, 512x768x121, stage 1 at batch 3 over "
        f"{TWO_STAGE_CFG_STEPS} steps, rank-{DISTILLED_LORA_RANK} distilled LoRA): {json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    upscale = upscaler_convs(SpatialUpscalerConfig())
    want_flash = _two_stage_flash(TWO_STAGE_CFG_LAYERS, len(SEEDS))
    want = {"fwd": sum(want_flash["by_head_dim"].values()), "bwd": 0,
            "conv": (upscale + conv_launches(VideoDecoderConfig()) * tiles) * len(SEEDS)}
    if counts != want or by_dim != want_flash["by_head_dim"] or by_batch != want_flash["by_batch"]:
        raise AssertionError(f"two-stage CFG launches {counts} {by_dim} {by_batch}, expected {want} {want_flash}")
    header = len(y4m_header(WIDTH, HEIGHT, 24.0)) + FRAMES * (6 + 3 * HEIGHT * WIDTH)
    wav = {"channels": 2, "rate": 24000, "samples": AV_WAV_SAMPLES[24000], "sample_bytes": 2}
    for f, st in zip(files, stats):
        if f != {"y4m_bytes": header, "wav": wav}:
            raise AssertionError(f"two-stage CFG files {f}, expected {header} y4m bytes and {wav}")
        if not (st["stage1_latent_finite"] and st["stage2_latent_finite"] and st["audio_finite"]):
            raise AssertionError(f"two-stage CFG: non-finite output {st}")
    if not drift or drift["tensors"] != lora_info["targets"] or drift["weights"] != target_weights:
        raise AssertionError(f"two-stage CFG: the drift check saw {drift}, not the {lora_info['targets']} fused "
                             f"weights")
    if not drift["untouched_equal"]:
        raise AssertionError(f"two-stage CFG: a weight the LoRA does not touch moved, or the draws are not "
                             f"make_dit's: {drift}")
    if drift["max_steps"] > TOL_LORA_DRIFT_STEPS:
        raise AssertionError(f"two-stage CFG: the unfused weights drifted {drift}")
    if not distinct:
        raise AssertionError("the two two-stage CFG requests produced identical clips")
    return rec, {"fwd": counts["fwd"], "fwd_by_head_dim": by_dim, "fwd_by_batch": by_batch,
                 "conv_fp32": upscale * len(SEEDS), "conv_bf16": counts["conv"] - upscale * len(SEEDS)}


# The two-stage CFG and a2vid small checks (kernels against plain): the AV
# small check's size and limits; two-stage's stage 1 over 4 steps with a
# rank-8 LoRA, a2vid from a random 17 / 24 s stereo source. The guided
# stage 1 multiplies the rows' differences, the kernels' bf16 rounding
# among them, by up to 1 + (cfg - 1) + (modality - 1) = 5, so its latents
# are held to 5x the AV check's rms limit (measured on the card, NVIDIA
# H100 80GB HBM3, 700 W: stage 1 1.0e-2, upscale 1.7e-2, stage 2 3.6e-3,
# audio 4.5e-3; another seed's audio 1.37).
MM_SMALL_STEPS, MM_SMALL_LORA_RANK = 4, 8
TOL_MM_SMALL_LATENT_RMS_REL = 5 * TOL_SMALL_LATENT_RMS_REL


def phase_two_stage_cfg_small(smi: str) -> dict:
    """The two-stage CFG pipeline (with a distilled LoRA) and a2vid end to
    end (tiled video decode; the audio decode for two-stage) at a small
    size, through the kernels against the same pipelines with every flash
    and conv call on its plain version: 2 full-width AV blocks in bf16
    (AdaLN and cross-modal tables drawn non-zero), a mid-16 upscaler, a
    base-16 bf16 decoder, a small audio decoder, vocoder and audio encoder,
    128x128x17 (18 audio tokens). Latents, audio latent and frames at the
    AV small check's limits (two-stage's latents at 5x its rms limit: the
    guidance gain); a2vid's audio latent frozen bit for bit in both runs; a
    run from another seed must fail the limits."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import av_config, make_dit
    from ltx2_tpu_torch.loader.lora import LoRAConfig
    from ltx2_tpu_torch.models.audio_vae import (
        AudioDecoder, AudioDecoderConfig, AudioEncoder, AudioEncoderConfig, Vocoder, VocoderConfig,
        init_audio_decoder_, init_audio_encoder_, init_vocoder_,
    )
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig, init_video_decoder_
    from ltx2_tpu_torch.models.video_vae.tiling import SpatialTilingConfig, TemporalTilingConfig, TilingConfig
    from ltx2_tpu_torch.pipelines.a2vid_two_stage import A2VidConfig, A2VidPipelineTwoStage
    from ltx2_tpu_torch.pipelines.common import decode_audio, decode_video
    from ltx2_tpu_torch.pipelines.distilled import stage_seeds
    from ltx2_tpu_torch.pipelines.two_stage import TwoStageCFGConfig, TwoStagePipeline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(51)
    dit = make_dit(AV_SMALL["layers"], dev, seed=52, base=av_config(LTXModelConfig(in_channels=16, out_channels=16)))
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    up = init_spatial_upscaler_(SpatialUpscaler(SpatialUpscalerConfig(16, 16, 1, 4), device=dev), gen)
    dec = init_video_decoder_(VideoDecoder(VideoDecoderConfig(base_channels=16, latent_channels=16,
                                                              compute_dtype="bfloat16"), device=dev), gen)
    adec = init_audio_decoder_(AudioDecoder(AudioDecoderConfig(ch=16, num_res_blocks=1), device=dev), gen)
    voc = init_vocoder_(Vocoder(VocoderConfig(upsample_initial_channel=64), device=dev), gen)
    enc = init_audio_encoder_(AudioEncoder(AudioEncoderConfig(ch=16, num_res_blocks=1), device=dev), gen)
    ctx = [torch.randn(1, 16, w, generator=gen, device=dev) * 0.5
           for w in (dit.cfg.cross_attention_dim,) * 2 + (dit.cfg.audio_inner_dim,) * 2]
    source = np.random.default_rng(53).standard_normal((2, 16000 * AV_SMALL["frames"] // 24)).astype(np.float32) * 0.3
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))
    size = dict(height=AV_SMALL["height"], width=AV_SMALL["width"], num_frames=AV_SMALL["frames"], fps=24.0,
                dtype="bfloat16", latent_channels=16, tiling_config=tiling, audio_enabled=True)
    directory = tempfile.mkdtemp(prefix="ltx2_mm_small_")
    try:
        lora_path = os.path.join(directory, "lora.safetensors")
        _write_distilled_lora(lora_path, dit, rank=MM_SMALL_LORA_RANK)
        two = TwoStagePipeline(dit, up, video_decoder=dec)
        a2v = A2VidPipelineTwoStage(dit, up, video_decoder=dec, audio_encoder=enc)

        originals = {n: p.detach().clone() for n, p in dit.named_parameters()}

        def run_two(seed):
            """From the original weights: each fuse-and-unfuse may move a weight by a bf16 step."""
            with torch.no_grad():
                for n, p in dit.named_parameters():
                    p.copy_(originals[n])
            latents = {}
            config = TwoStageCFGConfig(seed=seed, num_inference_steps=MM_SMALL_STEPS, guidance_rescale=0.7,
                                       distilled_lora_config=LoRAConfig(lora_path), **size)
            latent, audio_latent = two(ctx[0], ctx[1], config, positive_audio_encoding=ctx[2],
                                       negative_audio_encoding=ctx[3], skip_decode=True,
                                       callback=lambda phase, z: latents.setdefault(phase, z.float()))
            frames = decode_video(latent, dec, tiling, stage_seeds(seed)[2])
            return frames, latents, audio_latent.float()

        def run_a2vid(seed):
            latents = {}
            latent, _, _ = a2v(ctx[0], A2VidConfig(seed=seed, **size), audio_encoding=ctx[2], source_waveform=source,
                               skip_decode=True, callback=lambda phase, z: latents.setdefault(phase, z.float()))
            frames = decode_video(latent, dec, tiling, stage_seeds(seed)[2])
            return frames, latents, list(a2v.frozen_by_stage)

        _reset_counts()
        _reset_flash_by()
        frames_k, lat_k, audio_k = run_two(5)
        two_by = {"head_dim": _flash_by("launches_by_head_dim"), "batch": _flash_by("launches_by_batch")}
        _reset_flash_by()
        a_frames_k, a_lat_k, frozen_k = run_a2vid(5)
        a2vid_by = {"head_dim": _flash_by("launches_by_head_dim"), "batch": _flash_by("launches_by_batch")}
        wave_k = decode_audio(audio_k, adec, voc)
        with _plain_kernels():
            frames_p, lat_p, audio_p = run_two(5)
            frames_o, _, audio_o = run_two(6)
            a_frames_p, a_lat_p, frozen_p = run_a2vid(5)
            a_frames_o, _, _ = run_a2vid(6)
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    def err(a, b):
        return {x: v for x, v in _mismatch(a, b).items() if x != "ref_rms"}

    rec = {"two_stage": {"flash": two_by, "frames": list(frames_k.shape), "waveform": list(wave_k.shape),
                         "latents": {k: err(lat_k[k], lat_p[k]) for k in ("stage1", "upscale", "stage2")},
                         "audio_latent": err(audio_k, audio_p), "frames_vs_plain": _frame_diff(frames_k, frames_p),
                         "planted_other_seed": {"frames": _frame_diff(frames_o, frames_p),
                                                "audio_latent": err(audio_o, audio_p)}},
           "a2vid": {"flash": a2vid_by, "frozen_by_stage": [frozen_k, frozen_p],
                     "latents": {k: err(a_lat_k[k], a_lat_p[k]) for k in ("audio_encode", "stage1", "stage2")},
                     "frames_vs_plain": _frame_diff(a_frames_k, a_frames_p),
                     "planted_other_seed": {"frames": _frame_diff(a_frames_o, a_frames_p)}},
           "tol_latent_rms_rel": {"two_stage": TOL_MM_SMALL_LATENT_RMS_REL, "a2vid": TOL_SMALL_LATENT_RMS_REL},
           "tol_mean_levels": TOL_SMALL_MEAN_LEVELS, "card": smi}
    log(f"two-stage CFG and a2vid small-input checks (kernels vs plain on the card): {json.dumps(rec)}")
    del two, a2v, dit, up, dec, adec, voc, enc, originals
    torch.cuda.empty_cache()
    steps = MM_SMALL_STEPS + 3
    per_step = sum(AV_FLASH_PER_BLOCK.values()) * AV_SMALL["layers"]
    want_two = {"head_dim": _av_flash(AV_SMALL["layers"], steps, 1),
                "batch": {3: per_step * MM_SMALL_STEPS, 1: per_step * 3}}
    want_a2vid = {"head_dim": _av_flash(AV_SMALL["layers"], 8 + 3, 1), "batch": {1: per_step * 11}}
    if two_by != want_two or a2vid_by != want_a2vid:
        raise AssertionError(f"small checks' flash launches {two_by} {a2vid_by}, expected {want_two} {want_a2vid}")
    if frozen_k != [True, True] or frozen_p != [True, True]:
        raise AssertionError(f"a2vid small check: the frozen audio latent moved: {frozen_k} {frozen_p}")
    for name, r, tol in (("two-stage", rec["two_stage"], TOL_MM_SMALL_LATENT_RMS_REL),
                         ("a2vid", rec["a2vid"], TOL_SMALL_LATENT_RMS_REL)):
        checked = list(r["latents"].values()) + ([r["audio_latent"]] if "audio_latent" in r else [])
        if not all(c["finite"] for c in checked) or any(c["rms_rel_err"] > tol for c in checked):
            raise AssertionError(f"{name} small check: latents disagree with the plain path: {r}")
        if r["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
            raise AssertionError(f"{name} small check: frames disagree with the plain path: {r['frames_vs_plain']}")
        if r["planted_other_seed"]["frames"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS:
            raise AssertionError(f"the {name} small check accepts another seed's clip: {r['planted_other_seed']}")
    if rec["two_stage"]["planted_other_seed"]["audio_latent"]["rms_rel_err"] <= TOL_MM_SMALL_LATENT_RMS_REL:
        raise AssertionError(f"the two-stage small check accepts another seed's audio: {rec['two_stage']}")
    return rec


AV_FILE_LAYERS = 2


def _write_av_files(directory: str, dev) -> dict:
    """The AV file phase's files, by the port's writers: for V1 and for V2
    (LTX-2.3, with `vocoder.bwe` metadata) a 2-layer full-width AV DiT in
    the reference `-fp8` layout with the published audio decoder (its
    statistics drawn) and the vocoder (V1: LTX-2's HiFi-GAN; V2: the BWE
    chain of models/audio_vae/card_check.py's LTX23_VOCODER); V2 also holds
    the full-width VAE decoder; and the spatial upscaler."""
    import os

    import torch

    from ltx2_tpu_torch.generate import (
        av_config, make_audio_decoder, make_decoder, make_dit, make_upscaler, make_vocoder,
    )
    from ltx2_tpu_torch.loader.export import iter_fp8_checkpoint_specs
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors, write_safetensors_streaming
    from ltx2_tpu_torch.models.audio_vae.card_check import LTX23_VOCODER
    from ltx2_tpu_torch.models.audio_vae.vocoder import VocoderConfig, vocoder_with_bwe_config_from_checkpoint
    from ltx2_tpu_torch.models.audio_vae.weights import audio_decoder_to_checkpoint, vocoder_to_checkpoint
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import upscaler_to_checkpoint
    from ltx2_tpu_torch.models.video_vae.decoder import DEFAULT_DECODER_BLOCKS
    from ltx2_tpu_torch.models.video_vae.weights import decoder_to_checkpoint

    gen = torch.Generator(device=dev).manual_seed(61)
    paths = {"v1": os.path.join(directory, "ltx-2-av-fp8.safetensors"),
             "v2": os.path.join(directory, "ltx-2.3-av-fp8.safetensors"),
             "upscaler": os.path.join(directory, "spatial-upscaler.safetensors")}
    blocks = [["res_x", {"num_layers": b[1]}] if b[0] == "res_x" else [b[0], {"multiplier": b[1], "residual": b[2]}]
              for b in DEFAULT_DECODER_BLOCKS]
    write_s = {}
    for version in ("v1", "v2"):
        v2 = version == "v2"
        adec = make_audio_decoder(dev, seed=62)
        with torch.no_grad():
            adec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.1)
            adec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
        vocoder = make_vocoder(dev, seed=63, cfg=vocoder_with_bwe_config_from_checkpoint(LTX23_VOCODER)
                               if v2 else VocoderConfig())
        others = {**audio_decoder_to_checkpoint(adec), **vocoder_to_checkpoint(vocoder)}
        del adec, vocoder
        if v2:
            others.update(decoder_to_checkpoint(make_decoder("bfloat16", dev)))
        config = {"transformer": {"num_attention_heads": 32, "attention_head_dim": 128,
                                  "audio_num_attention_heads": 32}, "vae": {"decoder_blocks": blocks}}
        if v2:
            config["vocoder"] = LTX23_VOCODER
        metadata = {"model_version": "2.3.0" if v2 else "2.0.0", "config": json.dumps(config)}
        dit = make_dit(AV_FILE_LAYERS, dev, seed=64, fp8=True, base=av_config(
            LTXModelConfig(cross_attention_adaln=v2, apply_gated_attention=v2)))
        t0 = time.perf_counter()
        write_safetensors_streaming(paths[version], [
            *iter_fp8_checkpoint_specs(dit),
            *((k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in others.items())], metadata=metadata)
        write_s[version] = time.perf_counter() - t0
        del dit, others
        torch.cuda.empty_cache()
    write_safetensors(paths["upscaler"], upscaler_to_checkpoint(make_upscaler(dev), v11=True))
    torch.cuda.empty_cache()
    return {"paths": paths, "gb": {k: os.path.getsize(p) / 1e9 for k, p in paths.items()}, "write_s": write_s}


def phase_av_files(smi: str) -> tuple:
    """Audio-video checkpoints from files: `_write_av_files` into a fresh
    temporary directory; the V1 file through `ModelLedger(include_audio=True,
    keep_fp8=True)`: the AV DiT (the audio stream's and the cross-modal fp8
    linears kept as the file's codes, bit for bit), the audio decoder and
    LTX-2's vocoder (24 kHz); then `generate.main --pipeline distilled
    --checkpoint <V2 file> --spatial-upscaler <file> --fp8-serving --audio
    --output <tmp>/clip.y4m` at 512x768x121: the BWE chain's 48 kHz .wav of
    240480 samples beside the .y4m, 6 flash launches an AV block a step.
    The files are deleted at the end. Returns (the record, the launches)."""
    import os
    import shutil
    import tempfile

    import torch

    import ltx2_tpu_torch.generate as G
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
    from ltx2_tpu_torch.models.audio_vae.vocoder import Vocoder
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.utils.model_ledger import ModelLedger
    from ltx2_tpu_torch.utils.video_io import y4m_header

    import dataclasses

    directory = tempfile.mkdtemp(prefix="ltx2_av_files_")
    rec = {"directory_free_gb": shutil.disk_usage(directory).free / 1e9, "card": smi}
    try:
        t0 = time.perf_counter()
        files = _write_av_files(directory, torch.device("cuda"))
        paths = files["paths"]
        rec.update(files_gb=files["gb"], checkpoint_write_s=files["write_s"], write_s=time.perf_counter() - t0)
        ledger = ModelLedger(paths["v1"], include_audio=True, keep_fp8=True, device="cuda")
        t0 = time.perf_counter()
        dit = ledger.transformer()
        adec, vocoder = ledger.audio_decoder(), ledger.vocoder()
        torch.cuda.synchronize()
        rec["v1_load_s"] = time.perf_counter() - t0
        f = SafetensorsFile(paths["v1"])
        key = "model.diffusion_model.transformer_blocks.1.video_to_audio_attn.to_k.weight"
        kept = dit.transformer_blocks[1].video_to_audio_attn.to_k
        exact = (torch.equal(kept.weight.cpu().view(torch.uint8), f.get(key).view(torch.uint8))
                 and float(kept.weight_scale) == float(f.get(key + "_scale").reshape(())))
        f.close()
        rec["v1"] = {"is_av": dit.cfg.is_av, "audio_inner_dim": dit.cfg.audio_inner_dim,
                     "dit_weight_gb": G.weight_bytes(dit) / 1e9, "fp8_codes_exact": exact,
                     "audio_decoder": dataclasses.asdict(adec.cfg), "vocoder": type(vocoder).__name__,
                     "sample_rate": vocoder.cfg.output_sample_rate}
        ok_v1 = dit.cfg.is_av and exact and isinstance(vocoder, Vocoder) and vocoder.cfg.output_sample_rate == 24000
        del dit, adec, vocoder, ledger
        torch.cuda.empty_cache()
        out = os.path.join(directory, "clip.y4m")
        _reset_counts()
        flash_attention.launches_by_head_dim = {}
        t0 = time.perf_counter()
        results, stats = G.main(["--pipeline", "distilled", "--checkpoint", paths["v2"], "--spatial-upscaler",
                                 paths["upscaler"], "--fp8-serving", "--audio", "--output", out, "--seed",
                                 str(SEEDS[0]), "--height", str(HEIGHT), "--width", str(WIDTH), "--num-frames",
                                 str(FRAMES), "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts, by_dim = _counts(), dict(flash_attention.launches_by_head_dim)
        st = stats[0]
        rec["v2_request"] = {"wall_s": wall, "launches": counts, "flash_by_head_dim": by_dim,
                             "seconds": {p: st[f"{p}_s"] for p in ("stage1", "upscale", "stage2", "decode",
                                                                    "audio_decode")},
                             "load_s": {k: st.get(f"{k}_init_s") for k in ("dit", "upscaler", "decoder",
                                                                          "audio_decoder", "vocoder")},
                             "y4m_bytes": os.path.getsize(out), "wav": _wav_header(out[:-4] + ".wav"),
                             "waveform": list(results[0][1].shape), "audio_finite": st["audio_finite"]}
        del results
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log(f"AV checkpoints from files (V1 through the ledger; a V2 request with the BWE vocoder): "
        f"{json.dumps(rec)}")
    if not ok_v1:
        raise AssertionError(f"the V1 AV file loaded wrongly: {rec['v1']}")
    r = rec["v2_request"]
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    upscale = upscaler_convs(SpatialUpscalerConfig())
    want_dim = _av_flash(AV_FILE_LAYERS, 8 + 3, 1)
    want = {"fwd": sum(want_dim.values()), "bwd": 0, "conv": upscale + conv_launches(VideoDecoderConfig()) * tiles}
    if r["launches"] != want or r["flash_by_head_dim"] != want_dim:
        raise AssertionError(f"V2 AV request from files: launches {r['launches']}, expected {want} {want_dim}")
    wav = {"channels": 2, "rate": 48000, "samples": AV_WAV_SAMPLES[48000], "sample_bytes": 2}
    if r["wav"] != wav or not r["audio_finite"]:
        raise AssertionError(f"V2 AV request from files: .wav {r['wav']}, expected {wav}")
    if r["y4m_bytes"] != len(y4m_header(WIDTH, HEIGHT, 24.0)) + FRAMES * (6 + 3 * HEIGHT * WIDTH):
        raise AssertionError(f"V2 AV request from files: .y4m of {r['y4m_bytes']} bytes")
    return rec, {"fwd": r["launches"]["fwd"], "fwd_by_head_dim": by_dim, "conv_fp32": upscale,
                 "conv_bf16": r["launches"]["conv"] - upscale}



# Image-to-video. The full-size phases take the committed 512x768 progressive
# JPEG (tests/fixtures_video); the small checks and the CLI call a PNG
# written here from the seed, 1000 x 600, so that every target size resizes
# and crops it.
IMAGE_SIZE, IMAGE_SEED, IMAGE_STRENGTH = (600, 1000), 11, 0.95
# The one-stage CFG pipeline at the JAX package's OneStageCFGConfig defaults,
# but its steps, cut from 30 for the whole script's time (to 15 first, to
# 10 since the data-parallel training phase).
ONE_STAGE = {"height": 480, "width": 704, "frames": 97, "steps": 10, "cfg_scale": 3.0, "rescale_scale": 0.7}
# The exactness gate: a 2-block DiT at 128x128x9, 3 steps.
GATE = {"layers": 2, "height": 128, "width": 128, "frames": 9, "steps": 3}


def _write_png(path: str, seed: int, size) -> str:
    """An 8-bit RGB PNG of a smooth pattern with noise from `seed`, written
    with zlib and struct; row y is filtered with filter y % 5 (None, Sub,
    Up, Average, Paeth), so the reader meets all five."""
    import struct
    import zlib

    import numpy as np

    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (17.0 + 9 * c)) + np.cos(yy / (23.0 + 7 * c)) for c in range(3)], axis=-1)
    px = np.clip(base * 60 + 128 + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    cur = px.reshape(h, w * 3).astype(np.int64)
    up = np.vstack([np.zeros((1, w * 3), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int64), cur[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int64), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    preds = [np.zeros_like(cur), left, up, (left + up) >> 1,
             np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))]
    raw = b"".join(bytes([y % 5]) + ((cur[y] - preds[y % 5][y]) & 255).astype(np.uint8).tobytes() for y in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return path


def encoder_flops(cfg, height: int, width: int) -> float:
    """FLOP of one encode of a single frame as the kernels compute it: every
    conv's 27 taps (the causal padding repeats the one frame), over the
    voxels it runs on (a temporal-stride-2 down block's conv sees the frame
    replicated: 2 frames)."""
    h, w, c = height // cfg.patch_size, width // cfg.patch_size, cfg.plan[0][1]
    total = 2.0 * h * w * 3 * cfg.patch_size ** 2 * 27 * c
    for kind, c_in, arg, stride in cfg.plan:
        if kind == "res":
            total += 2 * arg * 2.0 * h * w * c_in * 27 * c_in
        else:
            total += 2.0 * stride[0] * h * w * c_in * 27 * (arg // math.prod(stride))
            h, w = h // stride[1], w // stride[2]
    return total + 2.0 * h * w * cfg.final_channels * 27 * (cfg.latent_channels + 1)


def phase_encoder(smi: str, image: str) -> dict:
    """The full-width fp32 video encoder (the published plan, random
    weights) on the card: init, one frame at 256x384 and one at 512x768
    (each encoded twice, the second timed; the first makes the TF32 split),
    peak memory, the conv launches an encode (the plan's count, every one
    on the fp32 kernel), the 3xTF32 bound, and the 256x384 frame against
    the same weights on the CPU within 1e-5 rms and 1e-4 max relative."""
    import torch

    from ltx2_tpu_torch.generate import make_encoder
    from ltx2_tpu_torch.models.video_vae.card_check import encoder_against_cpu
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches, video_encoder_apply
    from ltx2_tpu_torch.pipelines.common import load_image_tensor

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = make_encoder(dev)
    torch.cuda.synchronize()
    rec = {"init_s": time.perf_counter() - t0, "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "params": sum(p.numel() for p in enc.parameters()), "expected_launches": conv_launches(enc.cfg),
           "frames": {}, "card": smi}
    for h, w in ((256, 384), (512, 768)):
        pixels = load_image_tensor(image, h, w, device=dev)
        times, launches = [], []
        for _ in range(2):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                latent = video_encoder_apply(enc, pixels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(_counts())
        flops = encoder_flops(enc.cfg, h, w)
        bound_s = 3 * flops / PEAK_TF32_FLOPS
        rec["frames"][f"{h}x{w}"] = {
            "first_s": times[0], "encode_s": times[1], "launches": launches[1], "tflop": flops / 1e12,
            "bound_s": bound_s, "pct_of_bound": 100 * bound_s / times[1], "latent_shape": list(latent.shape),
            "finite": bool(torch.isfinite(latent).all()), "latent_std": float(latent.std())}
    rec["tf32x3_split_gb"] = torch.cuda.memory_allocated() / 1e9 - rec["weights_gb"]
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["card_vs_cpu"] = encoder_against_cpu(enc, load_image_tensor(image, 256, 384))
    log(f"video encoder (full-width fp32, published plan): {json.dumps(rec)}")
    del enc
    torch.cuda.empty_cache()
    for name, f in rec["frames"].items():
        want = {"fwd": 0, "bwd": 0, "conv": rec["expected_launches"]}
        if f["launches"] != want or not f["finite"]:
            raise AssertionError(f"encode at {name}: launches {f['launches']}, expected {want}; finite {f['finite']}")
    if not rec["card_vs_cpu"]["ok"]:
        raise AssertionError(f"the encoder on the card disagrees with the CPU: {rec['card_vs_cpu']}")
    return rec


def phase_image_two_stage(smi: str, image: str):
    """The two-stage distilled recipe with one image at frame 0 (strength
    0.95) at full width and depth, 512x768x121, one request: each phase's
    seconds and peak memory, the frames, and the launches: 1056 flash, the
    encoder's convs at both stages and the upscaler's 19 on the fp32 kernel,
    the tiled decode's on the bf16 kernel."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos_distilled
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.pipelines.common import ImageCondition

    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    want = {"stage1_image_encode": encoder_convs(VideoEncoderConfig()), "stage1": 0,
            "upscale": upscaler_convs(SpatialUpscalerConfig()),
            "stage2_image_encode": encoder_convs(VideoEncoderConfig()), "stage2": 0,
            "decode": decoder_convs(VideoDecoderConfig()) * tiles}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos_distilled(
        [SEEDS[0]], height=HEIGHT, width=WIDTH, frames=FRAMES, layers=LAYERS, device="cuda", phase_peaks=True,
        images=[ImageCondition(image, 0, IMAGE_STRENGTH)])
    wall = time.perf_counter() - t0
    counts = _counts()
    st = stats[0]
    phases = ("stage1_image_encode", "stage1", "upscale", "stage2_image_encode", "stage2", "decode")
    rec = {"seconds": {p: st[f"{p}_s"] for p in phases}, "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
           "conv_launches": {p: st[f"{p}_conv_launches"] for p in phases}, "attention_launches":
           st["attention_launches"], "launches": counts, "decode_tiles": st["decode_tiles"],
           "init_s": {k: st[k] for k in ("dit_init_s", "encoder_init_s", "upscaler_init_s", "decoder_init_s")},
           "frames": list(frames[0].shape), "latent_std": st["latent_std"], "wall_s": wall, "card": smi}
    log(f"image-to-video two-stage ({WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, image at frame 0, strength "
        f"{IMAGE_STRENGTH}): {json.dumps(rec)}")
    if frames[0].shape != (FRAMES, HEIGHT, WIDTH, 3) or frames[0].dtype != np.uint8:
        raise AssertionError(f"image-to-video two-stage frames {frames[0].shape} {frames[0].dtype}")
    if not all(st[f"{p}_latent_finite"] for p in phases[:-1]):
        raise AssertionError(f"non-finite image-to-video latents {st}")
    if rec["conv_launches"] != want or st["attention_launches"] != TWO_STAGE_LAUNCHES_PER_CLIP:
        raise AssertionError(f"image-to-video two-stage launches {rec['conv_launches']} (expected {want}), "
                             f"attention {st['attention_launches']}")
    if counts != {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0, "conv": sum(want.values())}:
        raise AssertionError(f"image-to-video two-stage launches {counts}")
    fp32 = want["stage1_image_encode"] + want["stage2_image_encode"] + want["upscale"]
    return {"fwd": counts["fwd"], "conv_fp32": fp32, "conv_bf16": want["decode"]}, rec


def phase_one_stage(smi: str, image: str):
    """The one-stage CFG pipeline at the JAX package's defaults (480x704x97,
    CFG* at 3.0 with rescale 0.7: two guidance rows) but its steps (15 of
    30) with one image at frame 0, full width and depth, one request: image
    encode, denoise (and a step) and decode seconds, peaks, frames, and the
    launches: 2 x 48 x 15 flash (batch 2), the encoder's convs on the fp32
    kernel, the tiled decode's on the bf16 kernel."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos_one_stage
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.pipelines.common import ImageCondition

    c = ONE_STAGE
    latent_shape = (1, 128, (c["frames"] - 1) // 8 + 1, c["height"] // 32, c["width"] // 32)
    tiles = len(generate_tile_specs(latent_shape, TilingConfig.default()))  # 4290 voxels > 4000: tiled
    want = {"image_encode": encoder_convs(VideoEncoderConfig()), "denoise": 0,
            "decode": decoder_convs(VideoDecoderConfig()) * tiles}
    flash = 2 * LAYERS * c["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos_one_stage(
        [SEEDS[0]], height=c["height"], width=c["width"], frames=c["frames"], steps=c["steps"],
        cfg_scale=c["cfg_scale"], rescale_scale=c["rescale_scale"], layers=LAYERS, device="cuda", phase_peaks=True,
        images=[ImageCondition(image, 0, IMAGE_STRENGTH)])
    wall = time.perf_counter() - t0
    counts = _counts()
    st = stats[0]
    phases = ("image_encode", "denoise", "decode")
    rec = {"config": c, "tokens": math.prod(latent_shape[2:]), "seconds": {p: st[f"{p}_s"] for p in phases},
           "denoise_step_s": st["denoise_step_s"], "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
           "conv_launches": {p: st[f"{p}_conv_launches"] for p in phases}, "attention_launches":
           st["attention_launches"], "launches": counts, "decode_tiles": st["decode_tiles"],
           "init_s": {k: st[k] for k in ("dit_init_s", "encoder_init_s", "decoder_init_s")},
           "frames": list(frames[0].shape), "latent_std": st["latent_std"], "wall_s": wall, "card": smi}
    log(f"one-stage CFG* with an image ({c['width']}x{c['height']}x{c['frames']}f, {LAYERS} layers, {c['steps']} "
        f"steps): {json.dumps(rec)}")
    if frames[0].shape != (c["frames"], c["height"], c["width"], 3) or frames[0].dtype != np.uint8:
        raise AssertionError(f"one-stage frames {frames[0].shape} {frames[0].dtype}")
    if not (st["denoise_latent_finite"] and st["image_encode_latent_finite"]):
        raise AssertionError(f"non-finite one-stage latents {st}")
    if rec["conv_launches"] != want or st["attention_launches"] != flash:
        raise AssertionError(f"one-stage launches {rec['conv_launches']} (expected {want}), attention "
                             f"{st['attention_launches']} (expected {flash})")
    if counts != {"fwd": flash, "bwd": 0, "conv": sum(want.values())}:
        raise AssertionError(f"one-stage launches {counts}")
    return {"fwd": counts["fwd"], "conv_fp32": want["image_encode"], "conv_bf16": want["decode"]}, rec


# The encoder plan of the CPU tests: every stride kind at width 16 and 32.
SMALL_ENCODER_PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None),
                      ("down", 16, 16, (2, 1, 1)), ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)),
                      ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)), ("res", 32, 1, None))


def phase_one_stage_small(smi: str, image: str) -> dict:
    """The one-stage CFG* pipeline end to end (the image at frame 0, two
    guidance rows, per-token timesteps, tiled decode) at a small size,
    through the kernels, against the same pipeline on the same card with
    every flash and conv call on its plain version (whose agreement with
    the JAX package the CPU tests show): a 2-layer DiT of 2 x 128-wide
    heads, the small encoder plan in fp32, a base-16 bf16 decoder,
    128x128x17, 3 steps. A run from another seed must fail the same limits."""
    import torch

    from ltx2_tpu_torch.generate import make_dit, make_encoder
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.video_vae.decoder import (
        VideoDecoder, VideoDecoderConfig, conv_launches, init_video_decoder_,
    )
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import (
        SpatialTilingConfig, TemporalTilingConfig, TilingConfig, generate_tile_specs,
    )
    from ltx2_tpu_torch.pipelines.common import ImageCondition
    from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    dit = make_dit(2, dev, seed=32, base=LTXModelConfig(num_attention_heads=2, in_channels=16, out_channels=16,
                                                         cross_attention_dim=256))
    enc_cfg = VideoEncoderConfig(plan=SMALL_ENCODER_PLAN, latent_channels=16)
    dec_cfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="bfloat16")
    enc = make_encoder(dev, seed=33, cfg=enc_cfg)
    dec = init_video_decoder_(VideoDecoder(dec_cfg, device=dev), gen)
    with torch.no_grad():  # one set of latent statistics, as a checkpoint holds
        dec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.3)
        dec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
        enc.per_channel_statistics.load_state_dict(dec.per_channel_statistics.state_dict())
    pipe = OneStagePipeline(dit, video_encoder=enc, video_decoder=dec)
    positive, negative = (torch.randn(1, 16, 256, generator=gen, device=dev) * 0.5 for _ in range(2))
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))
    images = [ImageCondition(image, 0, IMAGE_STRENGTH)]

    def run(seed):
        latents = {}
        config = OneStageCFGConfig(height=128, width=128, num_frames=17, seed=seed, num_inference_steps=3,
                                   dtype="bfloat16", latent_channels=16, tiling_config=tiling)
        frames, _ = pipe(positive, negative, config, images=images,
                         callback=lambda phase, z: latents.setdefault(phase, z.float()))
        return frames, latents

    _reset_counts()
    frames_k, lat_k = run(5)
    counts = _counts()
    with _plain_kernels():
        frames_p, lat_p = run(5)
        frames_other, _ = run(6)

    rec = {"launches": counts, "frames": list(frames_k.shape),
           "latents": {k: {x: v for x, v in _mismatch(lat_k[k], lat_p[k]).items() if x != "ref_rms"} for k in lat_k},
           "frames_vs_plain": _frame_diff(frames_k, frames_p),
           "planted_other_seed": _frame_diff(frames_other, frames_p),
           "tol_latent_rms_rel": TOL_SMALL_LATENT_RMS_REL, "tol_mean_levels": TOL_SMALL_MEAN_LEVELS, "card": smi}
    log(f"one-stage small-input check (kernels vs plain on the card): {json.dumps(rec)}")
    del pipe, dit, enc, dec
    torch.cuda.empty_cache()
    # 3 steps x 2 layers x (self + cross attention), each on both rows at
    # once; the encoder's convs and 45 a decoder call, one call a tile.
    tiles = len(generate_tile_specs((1, 16, 3, 4, 4), tiling))
    want = {"fwd": 3 * 2 * 2, "bwd": 0, "conv": encoder_convs(enc_cfg) + conv_launches(dec_cfg) * tiles}
    if counts != want:
        raise AssertionError(f"small one-stage launches {counts}, expected {want}")
    if sorted(lat_k) != ["denoise", "image_encode"] or frames_k.shape != (17, 128, 128, 3):
        raise AssertionError(f"small one-stage output {rec}")
    if any(not r["finite"] or r["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL for r in rec["latents"].values()):
        raise AssertionError(f"small one-stage latents disagree with the plain path: {rec['latents']}")
    if rec["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"small one-stage frames disagree with the plain path: {rec['frames_vs_plain']}")
    if rec["planted_other_seed"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"the small one-stage check accepts another seed's clip: {rec}")
    return rec


# The one-stage loop options at the JAX defaults' size, steps cut from 30
# to 5 so that the phase stays well inside the run's time (10 until PR 24). Request A: the
# one-stage pipeline with the image at frame 0, CFG* with STG on block 29,
# Heun, GE, the late cross-attention scale, text-KV caching and a 512-token
# bucket (4290 -> 4608 tokens); request B: text-to-video with APG and
# guidance reuse every second step.
OPTIONS_STEPS = 5
OPTIONS_A = {"stg_scale": 1.0, "stg_blocks": [29], "sampler": "heun", "ge_gamma": 0.5, "cross_attn_scale": 0.5,
             "cross_attn_start_block": 40, "cache_text_kv": True}
OPTIONS_A_BUCKET = 512
OPTIONS_B_APG = {"scale": 3.0, "eta": 0.5, "norm_threshold": 5.0}
OPTIONS_B_INTERVAL = 2


def _options_flash(layers: int, steps: int, sigmas, request: str) -> dict:
    """Flash launches a request's loop makes, reckoned from the code: every
    forward launches self and text cross-attention in each block, on all
    its rows at once. A: a 3-row predictor every step and a 2-row corrector
    on every step whose next sigma is not 0 (the last step takes the
    denoised sample and runs none); every self-attention carries the
    bucket's key mask. B: a 2-row forward on steps i % 2 == 0, a 1-row one
    on the others."""
    if request == "A":
        forwards = steps + sum(1 for s in sigmas[1:steps + 1] if s != 0)
        return {"fwd": 2 * layers * forwards, "key_valid": layers * forwards}
    return {"fwd": 2 * layers * steps, "key_valid": 0}


def phase_one_stage_options(smi: str, image: str) -> dict:
    """Requests A and B through `generate_videos_one_stage` at full width
    and depth (48 blocks, bf16 random weights, 480x704x97, OPTIONS_STEPS
    steps) on one DiT, encoder and decoder: per request the image-encode,
    denoise, step and decode seconds, peaks, uint8 frames of the clip's
    shape, finite latents, and the flash, key-valid flash and conv
    launches, each equal to the count reckoned from the code."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.components.guiders import LtxAPGGuider
    from ltx2_tpu_torch.components.schedulers import LTX2Scheduler
    from ltx2_tpu_torch.generate import make_decoder, make_dit, make_encoder
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.generate import generate_videos_one_stage
    from ltx2_tpu_torch.pipelines.common import ImageCondition, bucketed_tokens

    c, dev = ONE_STAGE, torch.device("cuda")
    latent_shape = (1, 128, (c["frames"] - 1) // 8 + 1, c["height"] // 32, c["width"] // 32)
    tokens = math.prod(latent_shape[2:])
    tiles = len(generate_tile_specs(latent_shape, TilingConfig.default()))
    sigmas = LTX2Scheduler().execute(steps=OPTIONS_STEPS).tolist()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit, encoder, decoder = make_dit(LAYERS, dev), make_encoder(dev), make_decoder("bfloat16", dev)
    init_s = time.perf_counter() - t0
    requests = {
        "A": dict(images=[ImageCondition(image, 0, IMAGE_STRENGTH)], rescale_scale=c["rescale_scale"],
                  token_bucket=OPTIONS_A_BUCKET, **OPTIONS_A),
        "B": dict(rescale_scale=0.0, cfg_interval=OPTIONS_B_INTERVAL,
                  guider_override=LtxAPGGuider(**OPTIONS_B_APG)),
    }
    recs, counts_all = {}, {"fwd": 0, "key_valid": 0, "conv_fp32": 0, "conv_bf16": 0}
    for name, kwargs in requests.items():
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        frames, stats = generate_videos_one_stage(
            [SEEDS[0]], height=c["height"], width=c["width"], frames=c["frames"], steps=OPTIONS_STEPS,
            cfg_scale=c["cfg_scale"], device="cuda", phase_peaks=True, dit=dit, encoder=encoder, decoder=decoder,
            **kwargs)
        wall = time.perf_counter() - t0
        counts, key_valid, st = _counts(), _key_valid_launches(), stats[0]
        phases = (("image_encode",) if name == "A" else ()) + ("denoise", "decode")
        want_flash = _options_flash(LAYERS, OPTIONS_STEPS, sigmas, name)
        want_conv = {"image_encode": encoder_convs(VideoEncoderConfig()) if name == "A" else 0, "denoise": 0,
                     "decode": decoder_convs(VideoDecoderConfig()) * tiles}
        rec = {"options": {k: v for k, v in kwargs.items() if k != "images"} | {"image": name == "A"},
               "steps": OPTIONS_STEPS, "reduced": f"steps 30 -> {OPTIONS_STEPS}",
               "tokens": tokens, "bucket_tokens": bucketed_tokens(tokens, OPTIONS_A_BUCKET) if name == "A" else tokens,
               "seconds": {p: st[f"{p}_s"] for p in phases}, "denoise_step_s": st["denoise_step_s"],
               "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
               "launches": counts | {"key_valid": key_valid}, "expected_flash": want_flash,
               "conv_launches": {p: st.get(f"{p}_conv_launches", 0) for p in want_conv},
               "expected_conv": want_conv, "frames": list(frames[0].shape), "latent_std": st["latent_std"],
               "wall_s": wall, "card": smi}
        rec["options"]["guider_override"] = repr(rec["options"].get("guider_override"))
        log(f"one-stage options request {name} ({c['width']}x{c['height']}x{c['frames']}f, {LAYERS} layers, "
            f"{OPTIONS_STEPS} steps): {json.dumps(rec)}")
        if frames[0].shape != (c["frames"], c["height"], c["width"], 3) or frames[0].dtype != np.uint8:
            raise AssertionError(f"one-stage options {name}: frames {frames[0].shape} {frames[0].dtype}")
        if not all(st[f"{p}_latent_finite"] for p in phases if p != "decode"):
            raise AssertionError(f"one-stage options {name}: non-finite latents {st}")
        if {"fwd": counts["fwd"], "key_valid": key_valid} != want_flash or counts["bwd"]:
            raise AssertionError(f"one-stage options {name}: flash launches {counts}, key-valid {key_valid}, "
                                 f"expected {want_flash}")
        if rec["conv_launches"] != want_conv or counts["conv"] != sum(want_conv.values()):
            raise AssertionError(f"one-stage options {name}: conv launches {rec['conv_launches']} ({counts}), "
                                 f"expected {want_conv}")
        recs[name] = rec
        counts_all["fwd"] += counts["fwd"]
        counts_all["key_valid"] += key_valid
        counts_all["conv_fp32"] += want_conv["image_encode"]
        counts_all["conv_bf16"] += want_conv["decode"]
    if not recs["A"]["launches"]["key_valid"]:
        raise AssertionError("request A launched the key-valid route no time")
    del dit, encoder, decoder
    torch.cuda.empty_cache()
    return counts_all, {"init_s": init_s, "requests": recs}


def phase_one_stage_options_small(smi: str, image: str) -> dict:
    """Requests A (STG on block 1 of 2, the cross-attention scale from block
    1, a 64-token bucket padding 48 tokens: the key-valid route), B, and the
    stateful APG with momentum 0.5, each end to end (tiled decode) at the
    small size of phase_one_stage_small (2-layer DiT, small encoder plan,
    base-16 bf16 decoder, 128x128x17, 3 steps), through the kernels against
    the same pipeline with every flash and conv call on its plain version;
    a run from another seed must fail the same limits."""
    import torch

    from ltx2_tpu_torch.components.guiders import LtxAPGGuider, StatefulAPGGuider
    from ltx2_tpu_torch.components.schedulers import LTX2Scheduler
    from ltx2_tpu_torch.generate import make_dit, make_encoder
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.video_vae.decoder import (
        VideoDecoder, VideoDecoderConfig, conv_launches, init_video_decoder_,
    )
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import (
        SpatialTilingConfig, TemporalTilingConfig, TilingConfig, generate_tile_specs,
    )
    from ltx2_tpu_torch.pipelines.common import ImageCondition
    from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline

    dev, steps = torch.device("cuda"), 3
    gen = torch.Generator(device=dev).manual_seed(41)
    dit = make_dit(2, dev, seed=42, base=LTXModelConfig(num_attention_heads=2, in_channels=16, out_channels=16,
                                                         cross_attention_dim=256))
    enc_cfg = VideoEncoderConfig(plan=SMALL_ENCODER_PLAN, latent_channels=16)
    dec_cfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="bfloat16")
    enc = make_encoder(dev, seed=43, cfg=enc_cfg)
    dec = init_video_decoder_(VideoDecoder(dec_cfg, device=dev), gen)
    with torch.no_grad():
        dec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.3)
        dec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
        enc.per_channel_statistics.load_state_dict(dec.per_channel_statistics.state_dict())
    pipe = OneStagePipeline(dit, video_encoder=enc, video_decoder=dec)
    positive, negative = (torch.randn(1, 16, 256, generator=gen, device=dev) * 0.5 for _ in range(2))
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))
    sigmas = LTX2Scheduler().execute(steps=steps).tolist()
    tiles = len(generate_tile_specs((1, 16, 3, 4, 4), tiling))
    decode_convs = conv_launches(dec_cfg) * tiles
    requests = {
        "A": ({"rescale_scale": 0.7, "token_bucket": 64}, [ImageCondition(image, 0, IMAGE_STRENGTH)],
              OPTIONS_A | {"stg_blocks": [1], "cross_attn_start_block": 1}),
        "B": ({"rescale_scale": 0.0, "cfg_interval": OPTIONS_B_INTERVAL}, [],
              {"guider_override": LtxAPGGuider(**OPTIONS_B_APG)}),
        "stateful_apg": ({"rescale_scale": 0.0}, [],
                         {"guider_override": StatefulAPGGuider(**OPTIONS_B_APG, momentum=0.5)}),
    }
    recs = {}
    for name, (fields, images, kwargs) in requests.items():
        def run(seed):
            latents = {}
            config = OneStageCFGConfig(height=128, width=128, num_frames=17, seed=seed, num_inference_steps=steps,
                                       dtype="bfloat16", latent_channels=16, tiling_config=tiling, **fields)
            frames, _ = pipe(positive, negative, config, images=images,
                             callback=lambda phase, z: latents.setdefault(phase, z.float()), **kwargs)
            return frames, latents

        _reset_counts()
        frames_k, lat_k = run(5)
        counts, key_valid = _counts(), _key_valid_launches()
        with _plain_kernels():
            frames_p, lat_p = run(5)
            frames_other, _ = run(6)
        flash = _options_flash(2, steps, sigmas, "A" if name == "A" else "B")
        want = {"fwd": flash["fwd"], "bwd": 0,
                "conv": (encoder_convs(enc_cfg) if images else 0) + decode_convs}
        rec = {"launches": counts | {"key_valid": key_valid}, "expected": want | {"key_valid": flash["key_valid"]},
               "frames": list(frames_k.shape),
               "latents": {k: {x: v for x, v in _mismatch(lat_k[k], lat_p[k]).items() if x != "ref_rms"}
                           for k in lat_k},
               "frames_vs_plain": _frame_diff(frames_k, frames_p),
               "planted_other_seed": _frame_diff(frames_other, frames_p),
               "tol_latent_rms_rel": TOL_SMALL_LATENT_RMS_REL, "tol_mean_levels": TOL_SMALL_MEAN_LEVELS, "card": smi}
        log(f"one-stage options small-input check {name} (kernels vs plain on the card): {json.dumps(rec)}")
        if counts != want or key_valid != flash["key_valid"]:
            raise AssertionError(f"small one-stage options {name}: launches {counts}, key-valid {key_valid}, "
                                 f"expected {want}, {flash}")
        if frames_k.shape != (17, 128, 128, 3) or "denoise" not in lat_k:
            raise AssertionError(f"small one-stage options {name}: output {rec}")
        if any(not r["finite"] or r["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL for r in rec["latents"].values()):
            raise AssertionError(f"small one-stage options {name}: latents disagree with the plain path: "
                                 f"{rec['latents']}")
        if rec["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
            raise AssertionError(f"small one-stage options {name}: frames disagree with the plain path: "
                                 f"{rec['frames_vs_plain']}")
        if rec["planted_other_seed"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS:
            raise AssertionError(f"small one-stage options {name}: the check accepts another seed's clip: {rec}")
        recs[name] = rec
    del pipe, dit, enc, dec
    torch.cuda.empty_cache()
    return recs


def phase_image_gate(smi: str, image: str) -> dict:
    """Exactness: the one-stage pipeline (a 2-block full-width bf16 DiT, the
    full-width encoder, 128x128x9, 3 steps) with the image at strength 1.0
    keeps the denoise mask at 0 on frame 0, so the final latent's frame 0 is
    the encoder's latent (in the latent's bf16) bit for bit; a planted run
    at strength 0.9 must fail the same check."""
    import torch

    from ltx2_tpu_torch.generate import dummy_context, make_dit, make_encoder
    from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
    from ltx2_tpu_torch.pipelines.common import ImageCondition, load_image_tensor
    from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline

    dev, g = torch.device("cuda"), GATE
    dit, enc = make_dit(g["layers"], dev), make_encoder(dev)
    pipe = OneStagePipeline(dit, video_encoder=enc)
    gen = torch.Generator(device=dev).manual_seed(IMAGE_SEED)
    pos, neg = dummy_context(dit.cfg, gen, dev), dummy_context(dit.cfg, gen, dev)
    config = OneStageCFGConfig(height=g["height"], width=g["width"], num_frames=g["frames"], seed=IMAGE_SEED,
                               num_inference_steps=g["steps"], dtype=dit.cfg.compute_dtype)
    with torch.no_grad():
        encoded = video_encoder_apply(enc, load_image_tensor(image, g["height"], g["width"], dit.cfg.dtype, dev))
    rec = {"config": g, "card": smi}
    _reset_counts()
    for strength in (1.0, 0.9):
        latent, _ = pipe(pos, neg, config, images=[ImageCondition(image, 0, strength)], skip_decode=True)
        frame0 = latent[:, :, :1]
        rec[f"strength_{strength}"] = {
            "bitwise_equal": bool(torch.equal(frame0, encoded.to(latent.dtype))),
            "max_abs_diff": float((frame0.float() - encoded.to(latent.dtype).float()).abs().max())}
    rec["launches"] = _counts()
    log(f"image exactness gate (2-block DiT, strength 1.0 frame 0 vs the encoder's latent): {json.dumps(rec)}")
    del pipe, dit, enc
    torch.cuda.empty_cache()
    if not rec["strength_1.0"]["bitwise_equal"]:
        raise AssertionError(f"strength 1.0 did not keep frame 0 the encoder's latent: {rec}")
    if rec["strength_0.9"]["bitwise_equal"]:
        raise AssertionError(f"the exactness gate accepts the planted strength 0.9 run: {rec}")
    if not (rec["launches"]["fwd"] and rec["launches"]["conv"]):
        raise AssertionError(f"the gate's runs launched no kernel: {rec['launches']}")
    return rec


# The committed stills the CLI call takes beside the PNG, one latent frame each
# (tests/fixtures_video; PIL's decodes recorded in media_io.json).
CLI_STILLS = ("still_rgb16_96x144.png", "still_lzw_predictor_96x144.tif", "still_96x144.bmp", "still_rle_96x144.tga")
CLI_FRAMES = 8 * len(CLI_STILLS) + 1  # a latent frame for the PNG and each still


def phase_cli_image(smi: str, image: str) -> dict:
    """`generate.main` with `--pipeline text-to-video` at 2 blocks, 2 steps
    and 128x128x33 on the card, written to a temporary .y4m, with five
    `--image` conditions: the PNG at latent frame 0, then the committed
    16-bit RGB PNG, LZW + predictor TIFF, BMP and RLE TGA at frames 1-4 (each
    decoded on the host by the port's readers): frames and launches (flash:
    2 blocks x 2 attention calls x 2 steps; the encoder's convs once an
    image, one decoder call)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from ltx2_tpu_torch import generate
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs

    fixtures = Path(__file__).resolve().parent / FIXTURE_DIR
    images = [f"{image}:0:{IMAGE_STRENGTH}"] + [f"{fixtures / name}:{i + 1}:{IMAGE_STRENGTH}"
                                                for i, name in enumerate(CLI_STILLS)]
    torch.cuda.empty_cache()
    _reset_counts()
    directory = tempfile.mkdtemp(prefix="ltx2_cli_")
    try:  # a .y4m: the default .mp4 needs ffmpeg, which the card's machine lacks
        videos, stats = generate.main(["--pipeline", "text-to-video", *sum((["--image", i] for i in images), []),
                                       "--layers", "2", "--num-inference-steps", "2", "--height", "128", "--width",
                                       "128", "--frames", str(CLI_FRAMES), "--seed", str(IMAGE_SEED),
                                       "--output", os.path.join(directory, "cli.y4m")])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts = _counts()
    want = {"fwd": 2 * 2 * 2, "bwd": 0,
            "conv": len(images) * encoder_convs(VideoEncoderConfig()) + decoder_convs(VideoDecoderConfig())}
    rec = {"frames": list(videos[0].shape), "images": [Path(i.split(":")[0]).name for i in images],
           "launches": counts, "expected": want, "card": smi,
           "seconds": {p: stats[0][f"{p}_s"] for p in ("image_encode", "denoise", "decode")}}
    log(f"generate.main --pipeline text-to-video with 5 --image stills (2 blocks, 2 steps, 128x128x{CLI_FRAMES}): "
        f"{json.dumps(rec)}")
    torch.cuda.empty_cache()
    if rec["frames"] != [CLI_FRAMES, 128, 128, 3] or counts != want:
        raise AssertionError(f"the CLI's image-to-video run {rec}")
    return rec


def phase_stills(smi: str) -> dict:
    """The committed stills (tests/fixtures_video, "stills" in
    media_io.json: PIL's mode and decode of each) through the port on the
    card's host: `read_image` (the --image / --keyframe route) gives the
    SHA-256 of PIL's `convert("RGB")`, or refuses the file with the mode the
    JAX package names; each PNG also through the video readers' still route
    (`read_png`, every mode); the host ms of each decode (the best of 3) and
    its ms a megapixel."""
    from pathlib import Path

    from ltx2_tpu_torch.pipelines.common import read_image
    from ltx2_tpu_torch.utils.image_io import STILL_MODES, read_png

    fixtures = Path(__file__).resolve().parent / FIXTURE_DIR
    meta = json.loads((fixtures / MEDIA_JSON).read_text(encoding="utf-8"))["stills"]
    checks, ms = {}, {}
    for name, want in meta.items():
        path = str(fixtures / name)
        if want["mode"] in STILL_MODES:
            checks[name] = _sha256(read_image(path)) == want["sha256_pil_rgb_uint8"]
            ms[name] = _host_ms(lambda: read_image(path))
        else:
            try:
                read_image(path)
                checks[name] = False
            except ValueError as e:
                checks[name] = f"Unsupported image format: {want['mode']}." in str(e)
        if name.endswith(".png"):
            checks[f"{name} (video route)"] = _sha256(read_png(path)) == want["sha256_pil_rgb_uint8"]
            ms[f"{name} (video route)"] = _host_ms(lambda: read_png(path))
    megapixels = {k: meta[k.split(" ")[0]]["height"] * meta[k.split(" ")[0]]["width"] / 1e6 for k in ms}
    rec = {"checks": checks, "host_ms": ms, "host_ms_per_megapixel": {k: v / megapixels[k] for k, v in ms.items()},
           "card": smi}
    log(f"stills (host): {json.dumps(rec)}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"stills: {bad} differ from tests/fixtures_video/{MEDIA_JSON}")
    return rec


def phase_image_to_video(smi: str):
    """(a) the encoder alone, (b) the two-stage recipe with an image, (c) the
    one-stage CFG pipeline with an image, at full size (each from the
    committed 512x768 progressive JPEG) and small against its plain version,
    (d) the exactness gate, (e) the CLI route (the PNG and four committed
    stills); the PNG is written into a fresh temporary directory and deleted
    at the end."""
    import shutil
    import tempfile
    from pathlib import Path

    jpeg = str(Path(__file__).resolve().parent / FIXTURE_DIR / "still_progressive_512x768.jpg")
    directory = tempfile.mkdtemp(prefix="chip_smoke_image_")
    try:
        image = _write_png(f"{directory}/image.png", IMAGE_SEED, IMAGE_SIZE)
        rec = {"encoder": phase_encoder(smi, jpeg)}
        two_stage_counts, rec["two_stage"] = phase_image_two_stage(smi, jpeg)
        one_stage_counts, rec["one_stage"] = phase_one_stage(smi, jpeg)
        rec["one_stage_small_check"] = phase_one_stage_small(smi, image)
        options_counts, rec["one_stage_options"] = phase_one_stage_options(smi, image)
        rec["one_stage_options_small_check"] = phase_one_stage_options_small(smi, image)
        rec["exactness_gate"] = phase_image_gate(smi, image)
        rec["cli"] = phase_cli_image(smi, image)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return two_stage_counts, one_stage_counts, options_counts, rec


def _counters():
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

    return {"fwd": A.flash_attention, "bwd": A.flash_attention_bwd_kernel, "conv": conv3d_ndhwc_kernel}


def _reset_counts():
    for c in _counters().values():
        c.launches = 0
    _counters()["conv"].strided_launches = 0
    _counters()["fwd"].key_valid_launches = 0
    _counters()["bwd"].launches_by_head_dim = {}


def _key_valid_launches() -> int:
    """Flash launches with a key-valid mask since the last _reset_counts
    (also counted in _counts()["fwd"])."""
    return _counters()["fwd"].key_valid_launches


def _counts() -> dict:
    return {k: c.launches for k, c in _counters().items()}


def _adapter_grads(model) -> dict:
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.requires_grad}


def phase_train_steps(smi: str):
    """(a) the entry: 3 full-width, full-depth LoRA steps through
    `ltx2_tpu_torch.train.main`; finite losses, non-zero lora_B after step 1,
    a bit-identical base, and the launch counts the code implies."""
    import torch

    from ltx2_tpu_torch import train as T

    zero_b_after_step1 = []

    def on_step(i, model, loss):
        if i == 0:
            zero_b_after_step1.extend(n for n, p in model.named_parameters()
                                      if n.endswith(".lora_B") and not bool(p.detach().abs().amax() > 0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = T.main(["--synthetic", *map(str, T.BENCH_SHAPE), "--lora-rank", "16", "--steps", str(TRAIN_STEPS),
                  "--layers", str(LAYERS), "--device", "cuda", "--log-every", "1"], on_step=on_step)
    wall = time.perf_counter() - t0
    counts = _counts()
    bwd_by_head_dim = dict(_counters()["bwd"].launches_by_head_dim)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = res["model"]
    log(f"train entry: {TRAIN_STEPS} steps, {LAYERS} layers, {res['adapters']} adapters, losses {res['losses']}, "
        f"step s {res['step_s']}, wall {wall:.1f} s, peak {peak_gb:.1f} GB, launches {counts} | {smi}")

    if len(res["losses"]) != TRAIN_STEPS or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"training losses {res['losses']}")
    if res["adapters"] != 10 * LAYERS:  # q, k, v, out of both attentions + the two FF linears
        raise AssertionError(f"{res['adapters']} adapters, expected 10 linears x {LAYERS} blocks")
    if zero_b_after_step1:
        raise AssertionError(f"lora_B still zero after step 1: {zero_b_after_step1[:4]}")
    # With adapters on to_q/to_k/to_v of both attentions every attention call
    # needs dq, dk and dv: each step runs 2 * LAYERS forward launches, the
    # remat recompute 2 * LAYERS more, and one fused backward launch per call.
    expected = {"fwd": TRAIN_STEPS * 4 * LAYERS, "bwd": TRAIN_STEPS * 2 * LAYERS, "conv": 0}
    if counts != expected:
        raise AssertionError(f"training launches {counts}, expected {expected}")
    # The base: the same random weights drawn again must be bit-identical.
    fresh = dict(T.make_model(LAYERS, torch.device("cuda"), seed=0).named_parameters())
    changed = [n for n, p in model.named_parameters() if n in fresh and not torch.equal(p, fresh[n])]
    missing = [n for n, _ in model.named_parameters() if n not in fresh and not n.endswith(("lora_A", "lora_B"))]
    del fresh
    torch.cuda.empty_cache()
    if changed or missing:
        raise AssertionError(f"base weights changed by training: {changed[:4]} {missing[:4]}")
    log(f"train entry checks: losses finite, every lora_B non-zero after step 1, base bit-identical, "
        f"launches as reckoned {expected}")
    counts["bwd_by_head_dim"] = bwd_by_head_dim
    return model, counts


def phase_train_timing(model, smi: str) -> dict:
    """(b) the step at scripts/bench_train.py's shape (6144 tokens, 1024
    text tokens, uniform sigmas): 1 warm-up + 4 timed steps."""
    import torch

    from ltx2_tpu_torch import train as T

    dev = torch.device("cuda")
    step, batch, flops = T.bench_step(model, dev)
    loss = step(batch, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(4):
        loss = step(batch, torch.Generator(device=dev).manual_seed(4 + i))
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 4
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch.x0.shape[1]
    rec = {"layers": model.cfg.num_layers, "tokens": tokens, "text_tokens": batch.context.shape[1],
           "ms_per_step": sec * 1e3, "tflops": flops / sec / 1e12,
           "pct_of_bf16_peak": 100 * flops / sec / PEAK_BF16_FLOPS, "peak_memory_gb": peak_gb,
           "loss": float(loss), "card": smi}
    log(f"train step timing: {json.dumps(rec)}")
    if not math.isfinite(rec["loss"]):
        raise AssertionError(f"train step loss {rec['loss']}")
    return rec


def phase_train_gradcheck(smi: str) -> dict:
    """(c) adapter gradients of one loss on 2 full-width blocks at 6144
    tokens (1024 text tokens), through the kernels against the same model
    with attention through autograd of `flash_attention_plain`."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.training import TrainConfig, rectified_flow_loss
    from ltx2_tpu_torch.training.lora import add_lora_params_, lora_trainable_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    model = T.make_model(2, dev, seed=5)
    add_lora_params_(model, gen, rank=16, alpha=16.0)
    lora_trainable_mask(model)
    with torch.no_grad():  # random B, so that A gets a gradient too
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(generator=gen).mul_(0.02)
    arrays = T.synthetic_dataset(*T.BENCH_SHAPE, 1, model.cfg, seed=1, context_tokens=T.BENCH_CONTEXT_TOKENS)
    batch = T.make_batch(arrays, [0], dev)
    sigmas = torch.tensor([0.6], device=dev)
    noise = torch.randn(batch.x0.shape, generator=gen, device=dev)
    tc = TrainConfig()

    def grads():
        loss = rectified_flow_loss(model, batch, None, tc, sigmas, noise)
        loss.backward()
        g = _adapter_grads(model)
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    _reset_counts()
    loss_k, g_k = grads()
    counts = _counts()
    kernel = A.flash_attention
    A.flash_attention = lambda q, k, v, scale=None, kv_valid=None: A.flash_attention_plain(q, k, v, scale, kv_valid)
    try:
        loss_p, g_p = grads()
    finally:
        A.flash_attention = kernel
    flat_k = torch.cat([g_k[n].flatten() for n in sorted(g_k)])
    flat_p = torch.cat([g_p[n].flatten() for n in sorted(g_p)])
    overall = _mismatch(flat_k, flat_p)
    per_tensor = {n: _mismatch(g_k[n], g_p[n]) for n in sorted(g_k)}
    worst = max(per_tensor, key=lambda n: per_tensor[n]["rms_rel_err"])
    rec = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(g_k), "launches": counts,
           "max_rel_err": overall["max_rel_err"], "rms_rel_err": overall["rms_rel_err"],
           "worst_tensor": worst, "worst_rms_rel_err": per_tensor[worst]["rms_rel_err"],
           "worst_max_rel_err": per_tensor[worst]["max_rel_err"],
           "tol_max_rel": TOL_GRAD_MAX_REL, "tol_rms_rel": TOL_GRAD_RMS_REL}
    log(f"train gradient check (2 blocks, kernels vs plain attention): {json.dumps(rec)}")
    del model
    torch.cuda.empty_cache()
    if counts != {"fwd": 8, "bwd": 4, "conv": 0}:
        raise AssertionError(f"gradient check launches {counts}")
    if not all(_accepted(per_tensor[n], TOL_GRAD_MAX_REL, TOL_GRAD_RMS_REL) for n in per_tensor):
        raise AssertionError(f"adapter gradients through the kernels disagree: {worst} {per_tensor[worst]}")
    return rec


# ---- Training, part two: audio-video LoRA, the fp8 frozen base, the
# audio-branch freeze, exact resume, the audio-only DiT and prepare_data.

# The cut-depth checks (the freeze, resume, prepare_data's step) at full width.
CUT_LAYERS = 4
# The AV entries' depth (bf16 and on the fp8 base), cut from 48 for the whole
# script's time since the data-parallel training phase.
AV_TRAIN_LAYERS = 24
RESUME_STEPS, RESUME_AT = 4, 2
# A resumed run's last adapters against the uninterrupted run's, relative to
# the rms of what the two steps after the save moved them: both runs feed
# the same bits to the same kernels, but the fused backward adds each key
# block's dQ share in whatever order the blocks finish, so the gradients
# differ by fp32 summation order, carried through bf16 activations and
# AdamW's normalisation.
TOL_RESUME_RMS_REL = 1e-2
AUDIO_ONLY_SEED = 9


def _train_counts() -> dict:
    from ltx2_tpu_torch.ops import attention as A

    counts = _counts()
    counts["fwd_by_head_dim"] = _flash_by("launches_by_head_dim")
    counts["bwd_by_head_dim"] = dict(A.flash_attention_bwd_kernel.launches_by_head_dim)
    counts["key_valid"] = _key_valid_launches()
    return counts


def _reset_train_counts() -> None:
    _reset_counts()
    _reset_flash_by()


def _write_npz(directory: str, name: str, arrays: dict) -> str:
    import os

    import numpy as np

    path = os.path.join(directory, name)
    np.savez(path, **arrays)
    return path


def _base_changes(model, seed: int = 0) -> dict:
    """Every Linear of `model` against its draw made again on the card from
    make_dit's generator at `seed`, in its order (init_linear_'s weight then
    bias; an fp8 weight quantized again as make_dit quantizes it): the
    linears whose weight, scale or bias differs from the draw."""
    import torch

    from ltx2_tpu_torch.loader.fp8 import quantize_tensor_fp8
    from ltx2_tpu_torch.ops.common import Linear

    dtype = model.cfg.dtype
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    names = {id(m): n for n, m in model.named_modules()}
    changed, checked = [], 0
    for m in model.modules():
        if not isinstance(m, Linear):
            continue
        bound = 1.0 / (m.weight.shape[1] ** 0.5)
        scale = getattr(m, "weight_scale", None)
        w = torch.empty(m.weight.shape, dtype=dtype if scale is not None else m.weight.dtype,
                        device=m.weight.device).uniform_(-bound, bound, generator=gen)
        if scale is not None:
            codes, s = quantize_tensor_fp8(w)
            same = torch.equal(codes.view(torch.uint8), m.weight.view(torch.uint8)) and torch.equal(s, scale)
        else:
            same = torch.equal(w, m.weight)
        if m.bias is not None:
            b = torch.empty_like(m.bias).uniform_(-bound, bound, generator=gen)
            same = same and torch.equal(b, m.bias)
        if not same:
            changed.append(names[id(m)])
        checked += 1
    return {"changed": changed, "linears": checked}


def _expected_av_train(steps: int, layers: int) -> dict:
    """Launches of `steps` LoRA steps of the AV DiT: 6 attentions a block
    (video self and text at head dim 128; audio self, audio text, audio ->
    video and video -> audio at 64), each run forward and again in the
    remat recompute, and one fused backward each (adapters on every q, k
    and v need dq, dk and dv)."""
    fwd = {d: 2 * n * layers * steps for d, n in AV_FLASH_PER_BLOCK.items()}
    bwd = {d: n * layers * steps for d, n in AV_FLASH_PER_BLOCK.items()}
    return {"fwd": sum(fwd.values()), "bwd": sum(bwd.values()), "conv": 0, "fwd_by_head_dim": fwd,
            "bwd_by_head_dim": bwd, "key_valid": 2 * layers * steps}


def phase_train_av(smi: str, npz: str, arrays: dict, directory: str, fp8: bool) -> tuple:
    """The AV entry at full width and depth (`train.bench_arrays`' sample
    written as a --data npz): 3 LoRA steps of the AV DiT at AV_TRAIN_LAYERS
    blocks (bf16, or with `fp8` its linears kept in fp8 as a frozen base)
    through `train.main --audio --data`, saving the training state at the
    end; finite losses, every lora_B non-zero after step 1 (the audio
    blocks' too), the base bit for bit its seeded draw, the launches
    reckoned by `_expected_av_train`; then the state read back into the
    live tensors (bit for bit the file's) and the step timed at this shape
    (1 warm-up + 3 steps, uniform sigmas)."""
    import os

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
    from ltx2_tpu_torch.training.checkpoint import load_train_state

    name = "train_av_fp8" if fp8 else "train_av"
    state = os.path.join(directory, f"{name}_state.safetensors")
    zero_b = []

    def on_step(i, model, loss):
        if i == 0:
            zero_b.extend(n for n, p in model.named_parameters()
                          if n.endswith(".lora_B") and not bool(p.detach().abs().amax() > 0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    t0 = time.perf_counter()
    res = T.main(["--audio", "--data", npz, "--lora-rank", "16", "--steps", str(TRAIN_STEPS),
                  "--layers", str(AV_TRAIN_LAYERS),
                  "--device", "cuda", "--log-every", "1", "--save-state", state, "--save-every", str(TRAIN_STEPS)]
                 + (["--fp8-serving"] if fp8 else []), on_step=on_step)
    wall = time.perf_counter() - t0
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = res["model"]
    expected = _expected_av_train(TRAIN_STEPS, AV_TRAIN_LAYERS)
    audio_b = sum(1 for n, _ in model.named_parameters() if n.endswith(".lora_B") and "audio" in n)
    # The state: the file read back into the live tensors must equal the file.
    t0 = time.perf_counter()
    load_train_state(state, model, res["optimizer"], res["ema"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f = SafetensorsFile(state)
    live = dict(model.named_parameters())
    reload_equal = all(torch.equal(f.get(k).to(live[k[len("param."):]].device), live[k[len("param."):]])
                       for k in f.keys() if k.startswith("param."))
    f.close()
    state_rec = {"bytes": os.path.getsize(state), "save_s": res["state_save_s"], "load_s": load_s,
                 "reload_bitwise": reload_equal}
    os.remove(state)
    base = _base_changes(model)
    # The step at this shape: uniform sigmas, a fresh optimizer over the adapters.
    step, batch, flops = T.bench_step(model, torch.device("cuda"), arrays)
    step(batch, torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(3):
        loss = step(batch, torch.Generator(device="cuda").manual_seed(4 + i))
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 3
    timing = {"ms_per_step": sec * 1e3, "tflops": flops / sec / 1e12, "pct_of_bf16_peak": 100 * flops / sec / PEAK_BF16_FLOPS,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "loss": float(loss),
              "video_tokens": batch.x0.shape[1], "audio_tokens": batch.audio_x0.shape[1],
              "text_tokens": batch.context.shape[1], "audio_text_tokens": batch.audio_context.shape[1]}
    weight_gb = sum(t.numel() * t.element_size() for n, t in (*model.named_parameters(), *model.named_buffers())
                    if "lora" not in n) / 1e9
    rec = {"layers": AV_TRAIN_LAYERS, "fp8_base": fp8, "adapters": res["adapters"], "losses": res["losses"],
           "step_s": res["step_s"], "wall_s": wall, "peak_memory_gb": peak_gb, "base_weight_gb": weight_gb,
           "launches": counts, "expected_launches": expected, "audio_lora_B": audio_b,
           "base_linears_checked": base["linears"], "state": state_rec, "timing": timing, "card": smi}
    log(f"{name} entry: {json.dumps(rec)}")
    del model, res, step, batch
    torch.cuda.empty_cache()
    if len(rec["losses"]) != TRAIN_STEPS or not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"{name}: losses {rec['losses']}")
    if rec["adapters"] != 28 * AV_TRAIN_LAYERS:  # 4 linears in each of 6 attentions + 2 FF linears in each of 2 streams
        raise AssertionError(f"{name}: {rec['adapters']} adapters, expected 28 x {AV_TRAIN_LAYERS}")
    if zero_b or audio_b != 18 * AV_TRAIN_LAYERS:  # audio_attn1/2, audio_ff, both cross-modal attentions
        raise AssertionError(f"{name}: lora_B still zero after step 1 {zero_b[:4]}, audio lora_B {audio_b}")
    if base["changed"]:
        raise AssertionError(f"{name}: base weights changed by training: {base['changed'][:4]}")
    if counts != expected:
        raise AssertionError(f"{name}: launches {counts}, expected {expected}")
    if not reload_equal:
        raise AssertionError(f"{name}: the training state read back differs from its file")
    if not math.isfinite(timing["loss"]):
        raise AssertionError(f"{name}: timed step loss {timing['loss']}")
    log(f"{name} checks: losses finite, all {rec['adapters']} lora_B non-zero after step 1 ({audio_b} in the audio "
        f"stream), {base['linears']} base linears bit for bit their draws, launches as reckoned {expected}")
    return rec, counts


def phase_train_av_video_only(smi: str, directory: str) -> tuple:
    """A video-only dataset on the AV DiT (full width, CUT_LAYERS blocks):
    `--trainable to_q` with weight decay 0.1 trains the video streams' q
    projections, while the audio branch is frozen: every audio-branch
    weight (the audio stream's and both cross-modal q projections the regex
    also names) stays bit for bit its draw."""
    import re

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.generate import av_config
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.training import AUDIO_BRANCH_PATTERN

    cfg = av_config(LTXModelConfig())
    npz = _write_npz(directory, "video_only.npz", T.bench_arrays(cfg, audio=False))
    torch.cuda.empty_cache()
    _reset_train_counts()
    res = T.main(["--audio", "--data", npz, "--trainable", "to_q", "--weight-decay", "0.1", "--lr", "1e-3",
                  "--steps", "2", "--layers", str(CUT_LAYERS), "--device", "cuda"])
    counts = _train_counts()
    model = res["model"]
    audio_re = re.compile(AUDIO_BRANCH_PATTERN)
    base = _base_changes(model)
    regex_audio = [n for n, _ in model.named_parameters() if "to_q" in n and audio_re.search(n)]
    expected_changed = sorted(f"transformer_blocks.{i}.{a}.to_q" for i in range(CUT_LAYERS) for a in ("attn1", "attn2"))
    rec = {"layers": CUT_LAYERS, "losses": res["losses"], "trainable": len(res["trainable"]),
           "audio_branch_named_by_regex": len(regex_audio), "changed": sorted(base["changed"]),
           "linears_checked": base["linears"], "launches": counts, "card": smi}
    log(f"train_av_video_only: {json.dumps(rec)}")
    trainable_audio = [n for n in res["trainable"] if audio_re.search(n)]
    del model, res
    torch.cuda.empty_cache()
    if trainable_audio or not regex_audio:
        raise AssertionError(f"video-only dataset on the AV DiT: audio-branch parameters trainable {trainable_audio}")
    if sorted(base["changed"]) != expected_changed:
        raise AssertionError(f"video-only dataset on the AV DiT: changed linears {base['changed']}, expected "
                             f"{expected_changed} (every audio-branch weight bit for bit its draw)")
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"video-only dataset on the AV DiT: losses {rec['losses']}")
    return rec, counts


def phase_train_resume(smi: str, npz: str, directory: str) -> tuple:
    """Exact resume on the card (full width, CUT_LAYERS AV blocks, rank 16):
    RESUME_STEPS steps saving every RESUME_AT, then a run resumed
    from the step-RESUME_AT file: the file holds the adapters bit for bit,
    the resumed run's first loss equals the uninterrupted run's at that
    step bit for bit (the forward is deterministic), and its final adapters
    are within TOL_RESUME_RMS_REL of the uninterrupted run's, relative to
    what the last steps moved them (the backward's dQ order)."""
    import os
    import shutil

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile

    state, state_at = (os.path.join(directory, f"resume_{s}.safetensors") for s in ("last", "at"))
    flags = ["--audio", "--data", npz, "--lora-rank", "16", "--steps", str(RESUME_STEPS), "--layers",
             str(CUT_LAYERS), "--device", "cuda", "--lr", "1e-4"]
    snap = {}

    def on_step(i, model, loss):
        if i == RESUME_AT - 1:  # the state written after this step
            snap.update({n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad})
        if i == RESUME_AT:
            shutil.copy(state, state_at)

    torch.cuda.empty_cache()
    _reset_train_counts()
    straight = T.main(flags + ["--save-state", state, "--save-every", str(RESUME_AT)], on_step=on_step)
    counts = _train_counts()
    f = SafetensorsFile(state_at)
    saved_equal = all(torch.equal(f.get(f"param.{n}").to(p.device), p) for n, p in snap.items())
    f.close()
    final = {n: p.detach().clone() for n, p in straight["model"].named_parameters() if p.requires_grad}
    del straight["model"], straight["optimizer"]
    torch.cuda.empty_cache()
    resumed = T.main(flags + ["--resume", state_at])
    got = {n: p.detach() for n, p in resumed["model"].named_parameters() if p.requires_grad}
    diff = torch.cat([(got[n].float() - final[n].float()).flatten() for n in sorted(final)])
    moved = torch.cat([(final[n].float() - snap[n].float()).flatten() for n in sorted(final)])
    rms_rel = float(diff.pow(2).mean().sqrt() / moved.pow(2).mean().sqrt())
    rec = {"layers": CUT_LAYERS, "steps": RESUME_STEPS, "saved_at": RESUME_AT, "losses": straight["losses"],
           "resumed_losses": resumed["losses"], "start": resumed["start"], "saved_bitwise": saved_equal,
           "first_loss_bitwise": resumed["losses"][0] == straight["losses"][RESUME_AT],
           "final_rms_rel": rms_rel, "final_max_abs": float(diff.abs().max()), "tol_rms_rel": TOL_RESUME_RMS_REL,
           "bytes": os.path.getsize(state_at), "save_s": straight["state_save_s"],
           "load_s": resumed["state_load_s"], "card": smi}
    log(f"train resume: {json.dumps(rec)}")
    del resumed, got, final, snap
    for path in (state, state_at):
        os.remove(path)
    torch.cuda.empty_cache()
    if rec["start"] != RESUME_AT or len(rec["resumed_losses"]) != RESUME_STEPS - RESUME_AT:
        raise AssertionError(f"resume: started at {rec['start']} with {len(rec['resumed_losses'])} steps")
    if not (saved_equal and rec["first_loss_bitwise"]):
        raise AssertionError(f"resume: saved adapters bitwise {saved_equal}, first loss bitwise "
                             f"{rec['first_loss_bitwise']}")
    if not rms_rel <= TOL_RESUME_RMS_REL:
        raise AssertionError(f"resume: final adapters {rms_rel} rms off the uninterrupted run's (limit "
                             f"{TOL_RESUME_RMS_REL})")
    return rec, counts


def phase_train_av_gradcheck(smi: str, arrays: dict) -> dict:
    """Adapter gradients of one AV loss on 2 full-width AV blocks at the AV
    training shape, through the kernels against the same model with
    attention through autograd of `flash_attention_plain` (the pattern of
    phase_train_gradcheck)."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.training import TrainConfig, rectified_flow_loss
    from ltx2_tpu_torch.training.lora import add_lora_params_, lora_trainable_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    model = T.make_model(2, dev, seed=6, audio=True)
    add_lora_params_(model, gen, rank=16, alpha=16.0)
    lora_trainable_mask(model)
    with torch.no_grad():  # random B, so that A gets a gradient too
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(generator=gen).mul_(0.02)
    batch = T.make_batch(arrays, [0], dev)
    sigmas = torch.tensor([0.6], device=dev)
    noise = torch.randn(batch.x0.shape, generator=gen, device=dev)
    audio_noise = torch.randn(batch.audio_x0.shape, generator=gen, device=dev)
    tc = TrainConfig()

    def grads():
        loss = rectified_flow_loss(model, batch, None, tc, sigmas, noise, audio_noise)
        loss.backward()
        g = _adapter_grads(model)
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    _reset_train_counts()
    loss_k, g_k = grads()
    counts = _train_counts()
    kernel = A.flash_attention
    A.flash_attention = lambda q, k, v, scale=None, kv_valid=None: A.flash_attention_plain(q, k, v, scale, kv_valid)
    try:
        loss_p, g_p = grads()
    finally:
        A.flash_attention = kernel
    per_tensor = {n: _mismatch(g_k[n], g_p[n]) for n in sorted(g_k)}
    overall = _mismatch(torch.cat([g_k[n].flatten() for n in sorted(g_k)]),
                        torch.cat([g_p[n].flatten() for n in sorted(g_p)]))
    worst = max(per_tensor, key=lambda n: per_tensor[n]["rms_rel_err"])
    audio_worst = max((n for n in per_tensor if "audio" in n), key=lambda n: per_tensor[n]["rms_rel_err"])
    expected = _expected_av_train(1, 2)
    rec = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(g_k), "launches": counts,
           "max_rel_err": overall["max_rel_err"], "rms_rel_err": overall["rms_rel_err"],
           "worst_tensor": worst, "worst_rms_rel_err": per_tensor[worst]["rms_rel_err"],
           "worst_max_rel_err": per_tensor[worst]["max_rel_err"], "worst_audio_tensor": audio_worst,
           "worst_audio_rms_rel_err": per_tensor[audio_worst]["rms_rel_err"],
           "tol_max_rel": TOL_GRAD_MAX_REL, "tol_rms_rel": TOL_GRAD_RMS_REL, "card": smi}
    log(f"train AV gradient check (2 AV blocks, kernels vs plain attention): {json.dumps(rec)}")
    del model
    torch.cuda.empty_cache()
    if counts != expected:
        raise AssertionError(f"AV gradient check launches {counts}, expected {expected}")
    if not all(_accepted(per_tensor[n], TOL_GRAD_MAX_REL, TOL_GRAD_RMS_REL) for n in per_tensor):
        raise AssertionError(f"AV adapter gradients through the kernels disagree: {worst} {per_tensor[worst]}")
    return rec


def _audio_only_inputs(cfg, dev, seed: int):
    """An audio modality at the serving shape (126 tokens of a 121-frame
    clip, sigma 0.6) with a 1024-token audio context, its first 700 keys
    valid."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.components.patchifiers import AudioPatchifier
    from ltx2_tpu_torch.models.transformer.model import Modality
    from ltx2_tpu_torch.types import AudioLatentShape, VideoPixelShape

    shape = AudioLatentShape.from_video_pixel_shape(VideoPixelShape(1, FRAMES, HEIGHT, WIDTH, 24.0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros(1, T.BENCH_CONTEXT_TOKENS, dtype=torch.bool, device=dev)
    mask[:, :T.BENCH_AUDIO_TEXT_VALID] = True
    sigma = torch.tensor([0.6], device=dev)
    return Modality(latent=torch.randn(1, shape.frames, cfg.audio_in_channels, generator=gen, device=dev),
                    context=torch.randn(1, T.BENCH_CONTEXT_TOKENS, cfg.audio_inner_dim, generator=gen, device=dev) * 0.1,
                    context_mask=mask, timesteps=sigma, positions=AudioPatchifier(1).get_patch_grid_bounds(shape).to(dev),
                    sigma=sigma)


def phase_audio_only(smi: str) -> tuple:
    """The audio-only DiT (LTXModelType.AudioOnly): a full-width, full-depth
    bf16 forward at 126 audio tokens on the card (2 flash launches a block
    at head dim 64, the text one key-masked; x0 with a video modality passed
    too denoises the audio latent), then 2 full-width blocks through the
    kernels against the same weights on the CPU in float32, within the
    kernel check's limits, another seed's input rejected."""
    import copy
    import dataclasses

    import torch

    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.models.transformer.model import (
        LTXModelConfig, LTXModelType, ltx_model_apply, x0_model_apply,
    )

    dev = torch.device("cuda")
    cfg = LTXModelConfig(model_type=LTXModelType.AudioOnly)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dit = make_dit(LAYERS, dev, seed=AUDIO_ONLY_SEED, base=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    audio = _audio_only_inputs(cfg, dev, 1)
    video = audio.replace(latent=torch.zeros_like(audio.latent) + 5.0)  # ignored by the audio-only model
    with torch.no_grad():
        ltx_model_apply(dit, None, audio=audio)  # warm-up
        torch.cuda.synchronize()
        _reset_train_counts()
        t0 = time.perf_counter()
        velocity = ltx_model_apply(dit, None, audio=audio)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        counts = _train_counts()
        x0 = x0_model_apply(dit, video, audio=audio)
    x0_is_audio = bool(torch.equal(x0, audio.latent.float() - 0.6 * velocity))
    weight_gb = sum(p.numel() * p.element_size() for p in dit.parameters()) / 1e9
    rec = {"layers": LAYERS, "audio_tokens": audio.latent.shape[1], "init_s": init_s, "forward_ms": forward_ms,
           "weight_gb": weight_gb, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "finite": bool(torch.isfinite(velocity).all()), "shape": list(velocity.shape), "launches": counts,
           "x0_denoises_audio": x0_is_audio, "card": smi}
    del dit
    torch.cuda.empty_cache()
    # 2 blocks on the card through the kernels, then on the CPU in float32.
    small = make_dit(2, dev, seed=AUDIO_ONLY_SEED, base=cfg)
    with torch.no_grad():
        got = ltx_model_apply(small, None, audio=audio).cpu()
        other = ltx_model_apply(small, None, audio=_audio_only_inputs(cfg, dev, 2)).cpu()
        cpu = copy.deepcopy(small).to("cpu", torch.float32)
        cpu.cfg = dataclasses.replace(small.cfg, compute_dtype="float32")
        ref = ltx_model_apply(cpu, None, audio=audio.replace(**{k: getattr(audio, k).cpu() for k in (
            "latent", "context", "context_mask", "timesteps", "positions", "sigma")}))
    rec["small_vs_cpu"] = _mismatch(got, ref)
    rec["small_other_seed"] = _mismatch(other, ref)
    log(f"audio-only DiT: {json.dumps(rec)}")
    del small, cpu
    torch.cuda.empty_cache()
    expected = {"fwd": 2 * LAYERS, "bwd": 0, "conv": 0, "fwd_by_head_dim": {64: 2 * LAYERS}, "bwd_by_head_dim": {},
                "key_valid": LAYERS}
    if counts != expected or not rec["finite"] or rec["shape"] != [1, audio.latent.shape[1], cfg.audio_out_channels]:
        raise AssertionError(f"audio-only forward: launches {counts} (expected {expected}), finite {rec['finite']}, "
                             f"shape {rec['shape']}")
    if not x0_is_audio:
        raise AssertionError("audio-only x0 with both modalities passed is not the audio latent's")
    if not _accepted(rec["small_vs_cpu"]) or _accepted(rec["small_other_seed"]):
        raise AssertionError(f"audio-only DiT on the card vs the CPU: {rec['small_vs_cpu']}; another input "
                             f"{rec['small_other_seed']}")
    return rec, counts


PREP_CLIPS, PREP_FRAMES = 2, 9


def phase_prepare_data(smi: str, directory: str) -> tuple:
    """`prepare_data` at full width: 2 random clips of 512x768x9 (uint8)
    through the full-width fp32 encoder (random weights), each encode's
    convs on the fp32 kernel (the plan's count a clip), the npz's shapes,
    then one `train.main --data` LoRA step on it (CUT_LAYERS blocks)."""
    import numpy as np
    import torch

    from ltx2_tpu_torch import prepare_data as P
    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig, conv_launches

    rng = np.random.RandomState(3)
    pixels = _write_npz(directory, "clips.npz", {"pixels": rng.randint(
        0, 256, (PREP_CLIPS, 3, PREP_FRAMES, HEIGHT, WIDTH), dtype=np.uint8)})
    out = f"{directory}/latents.npz"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    t0 = time.perf_counter()
    res = P.main(["--pixels", pixels, "--placeholder", "--context-dim", "4096", "--output", out, "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = _train_counts()
    tokens = ((PREP_FRAMES - 1) // 8 + 1) * (HEIGHT // 32) * (WIDTH // 32)
    rec = {"clips": PREP_CLIPS, "shape": [PREP_FRAMES, HEIGHT, WIDTH], "encode_s": res["encode_s"], "wall_s": wall,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "x0": list(res["x0"].shape),
           "positions": list(res["positions"].shape), "finite": bool(np.isfinite(res["x0"]).all()),
           "launches": counts, "expected_conv": PREP_CLIPS * conv_launches(VideoEncoderConfig()), "card": smi}
    torch.cuda.empty_cache()
    step = T.main(["--data", out, "--lora-rank", "16", "--steps", "1", "--layers", str(CUT_LAYERS), "--device", "cuda"])
    rec["train_loss"] = step["losses"][0]
    log(f"prepare_data: {json.dumps(rec)}")
    del step
    torch.cuda.empty_cache()
    if counts["conv"] != rec["expected_conv"] or counts["fwd"] or counts["bwd"]:
        raise AssertionError(f"prepare_data launches {counts}, expected {rec['expected_conv']} fp32 convs")
    if rec["x0"] != [PREP_CLIPS, tokens, 128] or rec["positions"] != [PREP_CLIPS, 3, tokens, 2] or not rec["finite"]:
        raise AssertionError(f"prepare_data arrays {rec['x0']} {rec['positions']} finite {rec['finite']}")
    if not math.isfinite(rec["train_loss"]):
        raise AssertionError(f"a train step on prepare_data's npz: loss {rec['train_loss']}")
    return rec, counts


def phase_training_av(smi: str) -> dict:
    """The training phases of the AV slice, in one temporary directory."""
    import shutil
    import tempfile

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.generate import av_config
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig

    directory = tempfile.mkdtemp(prefix="ltx2_train_")
    try:
        arrays = T.bench_arrays(av_config(LTXModelConfig()))
        npz = _write_npz(directory, "av.npz", arrays)
        out = {}
        out["train_av"], out["train_av_counts"] = phase_train_av(smi, npz, arrays, directory, fp8=False)
        out["train_av_fp8"], out["train_av_fp8_counts"] = phase_train_av(smi, npz, arrays, directory, fp8=True)
        out["video_only"], out["video_only_counts"] = phase_train_av_video_only(smi, directory)
        out["resume"], out["resume_counts"] = phase_train_resume(smi, npz, directory)
        out["gradcheck"] = phase_train_av_gradcheck(smi, arrays)
        out["audio_only"], out["audio_only_counts"] = phase_audio_only(smi)
        out["prepare_data"], out["prepare_data_counts"] = phase_prepare_data(smi, directory)
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ---- Data-parallel training with ZeRO-1 and ZeRO-2 (train.py --dp-devices,
# --zero1, --zero2): DP_TRAIN_WORLD ranks on the card over gloo (and over
# nccl where the machine has a card per rank), each configuration against
# world 1's run of the same steps here.

DP_TRAIN_LAYERS = 8  # cut from 48: two ranks share one card, and the script's time
DP_TRAIN_WORLD = 2
DP_TRAIN_STEPS = 3
DP_TRAIN_SAMPLES = 4
DP_TRAIN_LR = "1e-3"  # a bf16 weight near 0.016 moves by a step of 1e-3, not of train.py's 1e-5
DP_TRAINABLE = r"transformer_blocks\.\d+\.attn1\.(to_q|to_k|to_v|to_out)\."
# name -> (flags, batch): ZeRO-2 with 2 microbatches needs 4 samples so that
# each rank takes one row of every microbatch.
DP_TRAIN_CONFIGS = {"dp": ([], 2), "zero1": (["--zero1"], 2), "zero2_accum2": (["--zero2", "--accum-steps", "2"], 4)}
DP_LORA_STEPS = 2
# Each rank's loss against world 1's: the same rows, sigmas and noise, bf16
# products over one row where world 1 runs two, and AdamW's sign on the
# elements whose gradient is near zero.
TOL_DP_LOSS_REL = 5e-3
DP_TRAIN_TIMEOUT_S = 600


def _dp_argv(npz: str, batch: int, flags: list, steps: int = DP_TRAIN_STEPS, lora: bool = False) -> list:
    argv = ["--data", npz, "--layers", str(DP_TRAIN_LAYERS), "--batch-size", str(batch), "--steps", str(steps),
            "--lr", DP_TRAIN_LR, "--device", "cuda", "--log-every", "1", *flags]
    return argv + (["--fp8-serving", "--lora-rank", "16"] if lora else ["--trainable", DP_TRAINABLE])


def _param_hash(params):
    """One int64 per tensor, the sum of (bits + 1) x an odd weight of the
    element's index, modulo 2^64: any change of an element's bits moves it."""
    import torch

    out = []
    for p in params:
        bits = p.detach().reshape(-1).view(torch.int16 if p.element_size() == 2 else torch.int32)
        w = torch.arange(bits.numel(), device=p.device, dtype=torch.int64).mul_(2654435761).remainder_(2 ** 32)
        out.append(((bits.to(torch.int64) + 1) * w.mul_(2).add_(1)).sum())
    return torch.stack(out).cpu()


def _dp_train_run(argv: list, record_grads: bool = False) -> dict:
    """train.main(argv) on this rank: losses, step seconds, each step's
    parameter hashes, peak memory, moment and gradient bytes, collective
    bytes by route, K1 / K3 launches, the exports it made, the trained
    parameters and, with `record_grads`, the gradients each update read."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.training import trainer

    hashes, exports, grads = [], [], []

    def on_step(i, model, loss):
        hashes.append(_param_hash([p for p in model.parameters() if p.requires_grad]))

    def recording_step(opt, g=None, sharded_grads=False):
        grads.append([x.to("cpu", copy=True) for x in g])  # on the host: the card's peak stays the run's own
        return update(opt, g, sharded_grads)

    export, update = T.export_lora_checkpoint, trainer.AdamW.step
    T.export_lora_checkpoint = lambda path, model, **kw: (exports.append(path), export(path, model, **kw))
    if record_grads:
        trainer.AdamW.step = recording_step
    gc.collect()  # the last run's model: its gradient hooks and optimizer form a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    _reset_counts()
    try:
        res = T.main(argv, on_step=on_step)
    finally:
        T.export_lora_checkpoint, trainer.AdamW.step = export, update
    torch.cuda.synchronize()
    counts = _counts()
    params = [p.detach() for p in res["model"].parameters() if p.requires_grad]
    return {"losses": res["losses"], "step_s": res["step_s"], "hashes": hashes, "exports": exports,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "moment_bytes": res["moment_bytes"],
            "grad_bytes": res["grad_bytes"], "bytes_by_route": copy.deepcopy(collectives.STATS["bytes"]),
            "launches": {"fwd": counts["fwd"], "bwd": counts["bwd"]}, "params": params, "grads": grads,
            "tc": res["optimizer"].tc}


def _zero1_replay(world: int, tc, grads_by_step: list, dp_params: list) -> bool:
    """ZeRO-1's optimizer (moments sharded over 'data', each rank's slice
    updated, the updated bits all-gathered) fed the gradients plain DP's
    run read, from the same seeded weights: plain DP's parameters bit for
    bit? K3 adds dQ in whatever order its key blocks finish, so two runs
    never read the same gradient bits; this feeds them the same."""
    import re

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.parallel.mesh import axis_of, create_mesh
    from ltx2_tpu_torch.training import AdamW, trainable_mask, zero1_opt_state_shardings

    model = T.make_model(DP_TRAIN_LAYERS, torch.device("cuda"), 0)
    pattern = re.compile(DP_TRAINABLE)
    trainable_mask(model, lambda name: bool(pattern.search(name)))
    params = [p for p in model.parameters() if p.requires_grad]
    axis = axis_of(create_mesh(data=world, model=1), "data")
    opt = AdamW(params, tc)
    opt.shard_(zero1_opt_state_shardings(params, axis), axis)
    for grads in grads_by_step:
        opt.step([g.to(p.device) for g, p in zip(grads, params)])
    return len(params) == len(dp_params) and all(torch.equal(a.cpu(), b) for a, b in zip(params, dp_params))


def _train_dp_rank(rank: int, world: int, npz: str, directory: str) -> dict:
    """One rank of phase_train_dp: each configuration through train.main
    --dp-devices, ZeRO-1's optimizer replaying plain DP's gradients, then
    LoRA on the fp8 base under --zero2 with --save."""
    import torch

    out = {}
    dp_params = dp_grads = None
    for name, (flags, batch) in DP_TRAIN_CONFIGS.items():
        t0 = time.perf_counter()
        rec = _dp_train_run(_dp_argv(npz, batch, ["--dp-devices", str(world), *flags]), record_grads=name == "dp")
        params, grads, tc = rec.pop("params"), rec.pop("grads"), rec.pop("tc")
        if name == "dp":
            dp_params, dp_grads, dp_tc = [p.cpu() for p in params], grads, tc
        elif name == "zero1":
            rec["max_abs_vs_dp_run"] = max(float((a.float() - b.to(a.device).float()).abs().max())
                                           for a, b in zip(params, dp_params))
        del params, grads
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        if name == "zero1":
            gc.collect()
            t0 = time.perf_counter()
            out["zero1_replay"] = {"equals_dp_bitwise": _zero1_replay(world, dp_tc, dp_grads, dp_params),
                                   "seconds": time.perf_counter() - t0}
            dp_params = dp_grads = None
    t0 = time.perf_counter()
    rec = _dp_train_run(_dp_argv(npz, 2, ["--dp-devices", str(world), "--zero2", "--save",
                                          f"{directory}/adapter.safetensors"], steps=DP_LORA_STEPS, lora=True))
    for key in ("params", "grads", "tc"):
        rec.pop(key)
    rec["seconds"] = time.perf_counter() - t0
    out["lora_fp8_zero2"] = rec
    return out


def _dp_expected(accum: int, steps: int) -> dict:
    """A rank's K1 / K3 launches: every attention of every block needs its
    gradient (attn1's projections train; attn2's queries follow from them),
    so each microbatch of a step runs 2 forward launches a block, 2 more in
    the remat recompute and 2 fused backward ones."""
    return {"fwd": steps * accum * 4 * DP_TRAIN_LAYERS, "bwd": steps * accum * 2 * DP_TRAIN_LAYERS}


def phase_train_dp(smi: str) -> tuple:
    """Data-parallel training on the card through `train.main`: world 1's
    runs here, then DP_TRAIN_WORLD ranks (`spawn_ranks`) for plain DP,
    --zero1 and --zero2 --accum-steps 2 (DP_TRAINABLE at DP_TRAIN_LAYERS
    full-width blocks, bench_train's 6144 tokens and 1024 text tokens,
    DP_TRAIN_STEPS steps), and LoRA on the fp8 base with --zero2 --save.
    Fails unless every rank's parameters are identical after every step,
    ZeRO-1's optimizer fed plain DP's recorded gradients gives plain DP's
    parameters bit for bit (`_zero1_replay`), the losses are within
    TOL_DP_LOSS_REL of world 1's, ZeRO-1 holds half of plain DP's moment
    bytes and ZeRO-2 half of world 1's gradient bytes a rank, the launches
    are as reckoned and only rank 0 writes the --save file. Returns (record,
    the K1 / K3 launches by path, summed over the ranks)."""
    import datetime
    import os
    import tempfile

    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.parallel.runtime import spawn_ranks

    t_phase = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="ltx2_train_dp_")
    try:
        arrays = T.synthetic_dataset(*T.BENCH_SHAPE, DP_TRAIN_SAMPLES, LTXModelConfig(), seed=3,
                                     context_tokens=T.BENCH_CONTEXT_TOKENS)
        npz = _write_npz(directory, "dp.npz", arrays)
        world1 = {}
        for batch, flags in ((2, []), (4, ["--accum-steps", "2"])):
            rec = _dp_train_run(_dp_argv(npz, batch, flags))
            for key in ("params", "grads", "tc"):
                rec.pop(key)
            world1[batch] = rec
        gc.collect()
        torch.cuda.empty_cache()
        world1_s = time.perf_counter() - t_phase
        routes = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= DP_TRAIN_WORLD else [])
        record, counts = {"world_1": {b: {k: r[k] for k in ("losses", "step_s", "peak_gb", "moment_bytes",
                                                            "grad_bytes", "launches")}
                                      for b, r in world1.items()},
                          "world_1_s": world1_s, "routes": {}}, {}
        for backend in routes:
            t0 = time.perf_counter()
            ranks = spawn_ranks(_train_dp_rank, DP_TRAIN_WORLD, os.path.join(directory, backend), npz, directory,
                                backend=backend, device="cuda", timeout=DP_TRAIN_TIMEOUT_S,
                                collective_timeout=datetime.timedelta(seconds=DP_TRAIN_TIMEOUT_S))
            wall = time.perf_counter() - t0
            out = {"wall_s": wall}
            for name, (flags, batch) in {**DP_TRAIN_CONFIGS, "lora_fp8_zero2": (None, 2)}.items():
                per_rank = [r[name] for r in ranks]
                for r in per_rank:
                    r["hashes"] = [h.tolist() for h in r["hashes"]]
                lora = name == "lora_fp8_zero2"
                steps = DP_LORA_STEPS if lora else DP_TRAIN_STEPS
                accum = 2 if name == "zero2_accum2" else 1
                expected = _dp_expected(accum, steps)
                rec = {"ranks": [{k: r[k] for k in ("losses", "step_s", "peak_gb", "moment_bytes", "grad_bytes",
                                                    "bytes_by_route", "launches", "seconds", "max_abs_vs_dp_run")
                                  if k in r} for r in per_rank],
                       "launches_expected_per_rank": expected}
                if not lora:
                    ref = world1[batch]
                    rec["world_1_losses"] = ref["losses"]
                    rec["loss_rel_err_vs_world_1"] = max(abs(a - b) / abs(b) for a, b in
                                                         zip(per_rank[0]["losses"], ref["losses"]))
                log(f"train DP over {backend}, {name} ({DP_TRAIN_WORLD} ranks, {DP_TRAIN_LAYERS} layers, batch "
                    f"{batch}): {json.dumps(rec)} | {smi}")
                for i, r in enumerate(per_rank):
                    if len(r["losses"]) != steps or not all(math.isfinite(x) for x in r["losses"]):
                        raise AssertionError(f"DP {name} rank {i} losses {r['losses']}")
                    if r["launches"] != expected:
                        raise AssertionError(f"DP {name} rank {i} launches {r['launches']}, expected {expected}")
                    if r["hashes"] != per_rank[0]["hashes"] or r["losses"] != per_rank[0]["losses"]:
                        raise AssertionError(f"DP {name}: rank {i}'s parameters or losses differ from rank 0's")
                if len(per_rank[0]["hashes"]) != steps:
                    raise AssertionError(f"DP {name}: {len(per_rank[0]['hashes'])} parameter hashes")
                if not lora and rec["loss_rel_err_vs_world_1"] > TOL_DP_LOSS_REL:
                    raise AssertionError(f"DP {name} losses {per_rank[0]['losses']} against world 1's "
                                         f"{world1[batch]['losses']} (limit {TOL_DP_LOSS_REL} relative)")
                out[name] = rec
                counts[f"train_dp_{backend}_{name}"] = {k: sum(r["launches"][k] for r in per_rank)
                                                        for k in ("fwd", "bwd")}
            dp, z1, z2 = (ranks[0][k] for k in DP_TRAIN_CONFIGS)
            out["zero1_replay"] = [r["zero1_replay"] for r in ranks]
            if not all(r["zero1_replay"]["equals_dp_bitwise"] for r in ranks):
                raise AssertionError(f"DP over {backend}: ZeRO-1's optimizer on plain DP's gradients gave other "
                                     "parameters than plain DP's")
            if z1["moment_bytes"] * 2 != dp["moment_bytes"]:
                raise AssertionError(f"ZeRO-1 moment bytes {z1['moment_bytes']} vs plain DP's {dp['moment_bytes']}")
            if z2["grad_bytes"] * 2 != world1[4]["grad_bytes"]:
                raise AssertionError(f"ZeRO-2 gradient bytes {z2['grad_bytes']} vs world 1's "
                                     f"{world1[4]['grad_bytes']} at --accum-steps 2")
            exports = [r["lora_fp8_zero2"]["exports"] for r in ranks]
            if exports != [[f"{directory}/adapter.safetensors"]] + [[]] * (DP_TRAIN_WORLD - 1) \
                    or not os.path.exists(f"{directory}/adapter.safetensors"):
                raise AssertionError(f"DP LoRA --save: exports by rank {exports}")
            os.remove(f"{directory}/adapter.safetensors")
            out["memory_per_rank"] = {"moment_bytes": {k: ranks[0][k]["moment_bytes"] for k in DP_TRAIN_CONFIGS},
                                      "grad_bytes": {k: ranks[0][k]["grad_bytes"] for k in DP_TRAIN_CONFIGS},
                                      "world_1_grad_bytes_accum2": world1[4]["grad_bytes"],
                                      "peak_gb": {k: [r[k]["peak_gb"] for r in ranks] for k in DP_TRAIN_CONFIGS}}
            log(f"train DP over {backend}: ZeRO-1 on plain DP's gradients bit for bit plain DP "
                f"{json.dumps(out['zero1_replay'])}, ranks identical every step, "
                f"{json.dumps(out['memory_per_rank'])}, wall {wall:.1f} s | {smi}")
            record["routes"][backend] = out
        record["seconds"] = time.perf_counter() - t_phase
        log(f"train DP phase: {record['seconds']:.1f} s, launches {json.dumps(counts)} | {smi}")
        return record, counts
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ---- Megatron-TP training (train.py --tp-devices, alone and on a (data,
# model) mesh with --dp-devices and ZeRO): TP-2 on 2 ranks and TP-2 x DP-2
# on 4, sharing the card over gloo (and over nccl where the machine has a
# card per rank), each against world 1's run of the same steps here.

TP_TRAIN_LAYERS = 4  # cut from 48: four ranks share one card, and the script's time
TP_TRAIN_STEPS = 2
TP_TRAIN_BATCH = 2
# attn1's column-parallel Q/K/V (weights and biases), its row-parallel out
# (the weight split, the bias replicated) and the split Q/K norms.
TP_TRAINABLE = r"transformer_blocks\.\d+\.attn1\.(to_q|to_k|to_v|to_out|q_norm|k_norm)\."
TP_HEADS = 32  # LTX-2.0's heads; a TP-2 rank's launches carry 16
# name -> (TP, DP, flags, LoRA on the fp8 base with --save)
TP_TRAIN_CONFIGS = {"tp2": (2, 1, [], False), "tp2_dp2_zero2": (2, 2, ["--zero2"], False),
                    "lora_fp8_tp2_dp2_zero1": (2, 2, ["--zero1"], True)}
# Each rank's loss against world 1's, as TOL_DP_LOSS_REL: the same rows,
# sigmas and noise; bf16 partial products summed over 'model' in fp32 where
# world 1 sums one product.
TOL_TP_LOSS_REL = 5e-3
TP_TRAIN_TIMEOUT_S = 600


def _tp_argv(npz: str, tp: int, dp: int, flags: list, lora: bool, save=None) -> list:
    argv = ["--data", npz, "--layers", str(TP_TRAIN_LAYERS), "--batch-size", str(TP_TRAIN_BATCH), "--steps",
            str(TP_TRAIN_STEPS), "--lr", DP_TRAIN_LR, "--device", "cuda", "--log-every", "1", *flags]
    if tp > 1:
        argv += ["--tp-devices", str(tp)]
    if dp > 1:
        argv += ["--dp-devices", str(dp)]
    if save:
        argv += ["--save", save]
    return argv + (["--fp8-serving", "--lora-rank", "16"] if lora else ["--trainable", TP_TRAINABLE])


def _tp_train_run(argv: list) -> dict:
    """train.main(argv) on this rank: losses, step seconds, each step's
    hashes of the replicated parameters and of all this rank's slices
    (one a tensor; under --fsdp also each trainable tensor's hash gathered
    over 'data'), peak memory, parameter and moment bytes and the bytes the
    ZeRO (or FSDP) rule expects of this rank, collective bytes by operation
    and route (forward and backward apart) and by axis (the run, and its
    last step also by operation and axis), K1 / K3 launches and heads a
    launch, the exports it called, the files it wrote."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.loader import export as E
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.parallel.fsdp import fsdp_dim, model_fsdp_axis
    from ltx2_tpu_torch.parallel.sharding import tp_split_dim
    from ltx2_tpu_torch.training import checkpoint as C
    from ltx2_tpu_torch.training import lora as L

    hashes, calls, writes = [], [], []

    def on_step(i, model, loss):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        rec = {"replicated": _param_hash([p for n, p in named if tp_split_dim(n) is None]).tolist(),
               "all": _param_hash([p for _, p in named]).tolist()}
        axis = model_fsdp_axis(model)
        if axis is not None:  # every rank gathers, in one order
            rec["sliced"] = [fsdp_dim(p) is not None for _, p in named]
            rec["gathered"] = _param_hash([p if fsdp_dim(p) is None else
                                           collectives.all_gather(p.detach(), axis, fsdp_dim(p))
                                           for _, p in named]).tolist()
        hashes.append(rec)

    saved = (T.export_lora_checkpoint, L.write_safetensors, E.write_safetensors_streaming,
             C.write_safetensors_streaming)
    T.export_lora_checkpoint = lambda path, model, **kw: (calls.append(path), saved[0](path, model, **kw))
    L.write_safetensors = lambda path, *a, **kw: (writes.append(path), saved[1](path, *a, **kw))
    E.write_safetensors_streaming = lambda path, *a, **kw: (writes.append(path), saved[2](path, *a, **kw))
    C.write_safetensors_streaming = lambda path, *a, **kw: (writes.append(path), saved[3](path, *a, **kw))
    gc.collect()  # the last run's model: its gradient hooks and optimizer form a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    _reset_counts()
    A.flash_attention.launches_by_heads, A.flash_attention_bwd_kernel.launches_by_heads = {}, {}
    try:
        res = T.main(argv, on_step=on_step)
    finally:
        T.export_lora_checkpoint, L.write_safetensors, E.write_safetensors_streaming, \
            C.write_safetensors_streaming = saved
    torch.cuda.synchronize()
    counts = _counts()
    opt = res["optimizer"]
    if model_fsdp_axis(res["model"]) is not None:
        layout = _fsdp_layout_bytes(res["model"], opt)
    else:
        layout = {"moments": _tp_moment_bytes(res["model"], opt)}
    return {"losses": res["losses"], "step_s": res["step_s"], "hashes": hashes, "calls": calls, "writes": writes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "param_bytes": res["param_bytes"],
            "moment_bytes": res["moment_bytes"], "moment_bytes_expected": layout["moments"],
            "layout_bytes": layout, "bytes_by_route": copy.deepcopy(collectives.STATS["bytes"]),
            "bytes_by_axis": copy.deepcopy(collectives.STATS["axes"]), "last_step_bytes": res["step_bytes"],
            "last_step_op_bytes": res["step_op_bytes"],
            "launches": {"fwd": counts["fwd"], "bwd": counts["bwd"]},
            "heads": {"fwd": dict(A.flash_attention.launches_by_heads),
                      "bwd": dict(A.flash_attention_bwd_kernel.launches_by_heads)}}


def _tp_moment_bytes(model, opt) -> int:
    """The moment bytes the layout rule gives this rank, from the whole
    leaves (world 1's shapes): mu and nu of each, its 1/TP where the TP
    rules split it, then its 1/DP where ZeRO finds a dim other than the TP
    one that divides."""
    from ltx2_tpu_torch.parallel.sharding import tp_split_dim, whole_shape
    from ltx2_tpu_torch.training import data_shard_dim, parameter_names

    tp, dp = model.cfg.tp_axis, opt.axis
    total = 0
    for p, name in zip(opt.params, parameter_names(model, opt.params)):
        whole = whole_shape(name, p.shape, tp)
        split = tp is not None and tp_split_dim(name) is not None
        local = tuple(n // tp.size if split and i == tp_split_dim(name) else n for i, n in enumerate(whole))
        sliced = dp is not None and data_shard_dim(local, dp.size, tp_split_dim(name) if split else None) is not None
        total += 2 * p.element_size() * math.prod(whole) // (tp.size if split else 1) // (dp.size if sliced else 1)
    return total


def _fsdp_layout_bytes(model, opt) -> dict:
    """The bytes FSDP's rule gives this rank, from each leaf's whole shape
    (world 1's): its 1/TP where the TP rules split it, then its 1/DP where
    the first dim other than the TP one divides (failing where the model
    sliced another dim): {"params": every parameter's, "moments": mu and nu
    of the trainable ones, "whole": world 1's parameter bytes}."""
    from ltx2_tpu_torch.parallel.fsdp import fsdp_dim, model_fsdp_axis
    from ltx2_tpu_torch.parallel.sharding import tp_split_dim, whole_param_shape
    from ltx2_tpu_torch.training import data_shard_dim

    tp, dp = model.cfg.tp_axis, model_fsdp_axis(model)
    trainable = {id(p) for p in opt.params}
    out = {"params": 0, "moments": 0, "whole": 0}
    for name, p in model.named_parameters():
        whole, t = whole_param_shape(name, p.shape, model, fsdp_dim(p)), tp_split_dim(name)
        split = tp is not None and t is not None
        local = tuple(n // tp.size if split and i == t else n for i, n in enumerate(whole))
        d = data_shard_dim(local, dp.size, t)
        if d != fsdp_dim(p):
            raise AssertionError(f"FSDP: {name} sliced along {fsdp_dim(p)}, the rule gives {d}")
        held = math.prod(local) // (dp.size if d is not None else 1) * p.element_size()
        out["params"] += held
        out["moments"] += 2 * held if id(p) in trainable else 0
        out["whole"] += math.prod(whole) * p.element_size()
    return out


def _train_tp_rank(rank: int, world: int, npz: str, directory: str, jobs: list) -> dict:
    """One rank of phase_train_tp: each of `jobs` (names of TP_TRAIN_CONFIGS
    whose layout is this world) through train.main."""
    out = {}
    for name in jobs:
        tp, dp, flags, lora = TP_TRAIN_CONFIGS[name]
        t0 = time.perf_counter()
        save = f"{directory}/{name}.safetensors" if lora else None
        out[name] = _tp_train_run(_tp_argv(npz, tp, dp, flags, lora, save))
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def _tp_expected() -> dict:
    """A rank's K1 / K3 launches: every attention of every block needs its
    gradient, so each step runs 2 forward launches a block, 2 more in the
    remat recompute and 2 fused backward ones (over the rank's heads and
    its 'data' share of the rows)."""
    return {"fwd": TP_TRAIN_STEPS * 4 * TP_TRAIN_LAYERS, "bwd": TP_TRAIN_STEPS * 2 * TP_TRAIN_LAYERS}


def _safetensors_shapes(path: str) -> dict:
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile

    f = SafetensorsFile(path)
    try:
        return {k: list(f.info(k)[1]) for k in f.keys()}
    finally:
        f.close()


def phase_train_tp(smi: str) -> tuple:
    """Megatron-TP training on the card through `train.main`: world 1's runs
    here (TP_TRAINABLE, and LoRA on the fp8 base with --save), then TP-2 on
    2 ranks and TP-2 x DP-2 on 4 (`spawn_ranks`): --zero2, and LoRA rank 16
    on the fp8 base with --zero1 --save; TP_TRAIN_LAYERS full-width blocks,
    bench_train's 6144 tokens and 1024 text tokens, batch TP_TRAIN_BATCH,
    TP_TRAIN_STEPS steps. Fails unless each rank's losses are within
    TOL_TP_LOSS_REL of world 1's, the ranks of each 'model' line hold the
    same replicated parameters bit for bit after every step and the ranks of
    each 'data' line the same slices, each rank's moment bytes are what the
    layout rule gives (world 1's / TP for the split leaves, / DP more under
    ZeRO where a dim divides), the K1 / K3 launches are as reckoned with
    TP_HEADS / TP heads each, and only rank 0 writes the --save file, whose
    names and shapes are world 1's. Returns (record, the K1 / K3 launches by
    path, summed over the ranks, world 1's runs for phase_train_fsdp:
    {"runs": {lora: run}, "lora_shapes": the --save file's})."""
    import datetime
    import os
    import tempfile

    import torch

    from ltx2_tpu_torch.parallel.runtime import spawn_ranks

    t_phase = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="ltx2_train_tp_")
    try:
        npz = _tp_npz(directory)
        world1 = {lora: _tp_train_run(_tp_argv(npz, 1, 1, [], lora, f"{directory}/world1.safetensors" if lora
                                                else None)) for lora in (False, True)}
        world1_lora_shapes = _safetensors_shapes(f"{directory}/world1.safetensors")
        gc.collect()
        torch.cuda.empty_cache()
        record = {"world_1": {("lora_fp8" if k else "trainable"): {x: r[x] for x in (
            "losses", "step_s", "peak_gb", "moment_bytes", "launches", "heads")} for k, r in world1.items()},
            "world_1_s": time.perf_counter() - t_phase, "routes": {}}
        log(f"train TP world 1 ({TP_TRAIN_LAYERS} layers, batch {TP_TRAIN_BATCH}): {json.dumps(record)} | {smi}")
        for lora, r in world1.items():
            if r["launches"] != _tp_expected() or r["heads"] != {
                    k: {TP_HEADS: n} for k, n in r["launches"].items()}:
                raise AssertionError(f"TP world 1 (lora {lora}) launches {r['launches']} heads {r['heads']}")
        counts = {}
        for backend in ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 4 else []):
            out = {}
            for world in (2, 4):
                jobs = [k for k, (tp, dp, _, _) in TP_TRAIN_CONFIGS.items() if tp * dp == world]
                t0 = time.perf_counter()
                ranks = spawn_ranks(_train_tp_rank, world, os.path.join(directory, f"{backend}{world}"), npz,
                                    directory, jobs, backend=backend, device="cuda", timeout=TP_TRAIN_TIMEOUT_S,
                                    collective_timeout=datetime.timedelta(seconds=TP_TRAIN_TIMEOUT_S))
                out[f"wall_s_world_{world}"] = time.perf_counter() - t0
                for name in jobs:
                    tp, dp, _, lora = TP_TRAIN_CONFIGS[name]
                    per_rank = [r[name] for r in ranks]
                    ref = world1[lora]
                    expected = _tp_expected()
                    rec = {"ranks": [{k: r[k] for k in ("losses", "step_s", "peak_gb", "moment_bytes",
                                                        "moment_bytes_expected", "bytes_by_route", "bytes_by_axis",
                                                        "last_step_bytes", "launches", "heads", "seconds")}
                                     for r in per_rank],
                           "world_1_losses": ref["losses"], "world_1_moment_bytes": ref["moment_bytes"],
                           "loss_rel_err_vs_world_1": max(abs(a - b) / abs(b) for a, b in
                                                          zip(per_rank[0]["losses"], ref["losses"])),
                           "launches_expected_per_rank": expected}
                    log(f"train TP over {backend}, {name} (TP {tp} x DP {dp}, {TP_TRAIN_LAYERS} layers, batch "
                        f"{TP_TRAIN_BATCH}): {json.dumps(rec)} | {smi}")
                    heads = {k: {TP_HEADS // tp: n} for k, n in expected.items()}
                    for i, r in enumerate(per_rank):
                        if len(r["losses"]) != TP_TRAIN_STEPS or not all(math.isfinite(x) for x in r["losses"]):
                            raise AssertionError(f"TP {name} rank {i} losses {r['losses']}")
                        if r["launches"] != expected or r["heads"] != heads:
                            raise AssertionError(f"TP {name} rank {i} launches {r['launches']} heads {r['heads']}, "
                                                 f"expected {expected} at {heads}")
                        if r["moment_bytes"] != r["moment_bytes_expected"]:
                            raise AssertionError(f"TP {name} rank {i} moment bytes {r['moment_bytes']}, the layout "
                                                 f"rule gives {r['moment_bytes_expected']}")
                        if len(r["hashes"]) != TP_TRAIN_STEPS or r["losses"] != per_rank[0]["losses"]:
                            raise AssertionError(f"TP {name} rank {i}: {len(r['hashes'])} steps hashed, losses "
                                                 f"{r['losses']} against rank 0's {per_rank[0]['losses']}")
                    for d in range(dp):  # a 'model' line: the replicated leaves bit for bit
                        line = [per_rank[d * tp + m]["hashes"] for m in range(tp)]
                        if any([h["replicated"] for h in x] != [h["replicated"] for h in line[0]] for x in line):
                            raise AssertionError(f"TP {name}: the replicated parameters differ along 'model'")
                    for m in range(tp):  # a 'data' line: the same slices bit for bit
                        line = [per_rank[d * tp + m]["hashes"] for d in range(dp)]
                        if any([h["all"] for h in x] != [h["all"] for h in line[0]] for x in line):
                            raise AssertionError(f"TP {name}: the slices differ along 'data'")
                    if rec["loss_rel_err_vs_world_1"] > TOL_TP_LOSS_REL:
                        raise AssertionError(f"TP {name} losses {per_rank[0]['losses']} against world 1's "
                                             f"{ref['losses']} (limit {TOL_TP_LOSS_REL} relative)")
                    if lora:
                        path = f"{directory}/{name}.safetensors"
                        writes, calls = [r["writes"] for r in per_rank], [r["calls"] for r in per_rank]
                        want_calls = [[path] if i < tp else [] for i in range(world)]
                        if writes != [[path]] + [[]] * (world - 1) or calls != want_calls:
                            raise AssertionError(f"TP LoRA --save: writes by rank {writes}, exports by rank {calls}")
                        if _safetensors_shapes(path) != world1_lora_shapes:
                            raise AssertionError("TP LoRA --save: the file's names or shapes are not world 1's")
                        os.remove(path)
                    out[name] = rec
                    counts[f"train_tp_{backend}_{name}"] = {k: sum(r["launches"][k] for r in per_rank)
                                                            for k in ("fwd", "bwd")}
            record["routes"][backend] = out
        record["seconds"] = time.perf_counter() - t_phase
        log(f"train TP phase: {record['seconds']:.1f} s, launches {json.dumps(counts)} | {smi}")
        return record, counts, {"runs": world1, "lora_shapes": world1_lora_shapes}
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _tp_npz(directory: str) -> str:
    """phase_train_tp's data (and phase_train_fsdp's): TP_TRAIN_BATCH
    samples at bench_train's shape, 1024 text tokens, drawn from seed 4."""
    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig

    arrays = T.synthetic_dataset(*T.BENCH_SHAPE, TP_TRAIN_BATCH, LTXModelConfig(), seed=4,
                                 context_tokens=T.BENCH_CONTEXT_TOKENS)
    return _write_npz(directory, "tp.npz", arrays)


# ---- ZeRO-3/FSDP training (train.py --fsdp): every parameter sliced over
# 'data' (under TP, of the rank's TP slice), each block's weights gathered
# inside its remat unit and its gradients reduce-scattered; DP-2 on 2 ranks
# and TP-2 x DP-2 on 4, sharing the card over gloo (and over nccl where the
# machine has a card per rank), against phase_train_tp's world-1 runs of
# the same data and steps.

# name -> (TP, DP, LoRA rank 16 on the fp8 base with --save; else a full
# fine-tune of TP_TRAINABLE)
FSDP_TRAIN_CONFIGS = {"dp2": (1, 2, False), "tp2_dp2_lora_fp8": (2, 2, True)}
FSDP_TRAIN_TIMEOUT_S = 600


def _train_fsdp_rank(rank: int, world: int, npz: str, directory: str, jobs: list) -> dict:
    """One rank of phase_train_fsdp: each of `jobs` (names of
    FSDP_TRAIN_CONFIGS whose layout is this world) through train.main
    --fsdp."""
    out = {}
    for name in jobs:
        tp, dp, lora = FSDP_TRAIN_CONFIGS[name]
        t0 = time.perf_counter()
        save = f"{directory}/{name}.safetensors" if lora else None
        out[name] = _tp_train_run(_tp_argv(npz, tp, dp, ["--fsdp"], lora, save))
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def _fsdp_checks(name: str, per_rank: list, ref: dict, tp: int, dp: int) -> None:
    """phase_train_fsdp's gates on one job's ranks (see there)."""
    expected = _tp_expected()
    heads = {k: {TP_HEADS // tp: n} for k, n in expected.items()}
    for i, r in enumerate(per_rank):
        if len(r["losses"]) != TP_TRAIN_STEPS or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"FSDP {name} rank {i} losses {r['losses']}")
        if r["losses"] != per_rank[0]["losses"] or len(r["hashes"]) != TP_TRAIN_STEPS:
            raise AssertionError(f"FSDP {name} rank {i}: losses {r['losses']} against rank 0's "
                                 f"{per_rank[0]['losses']}, {len(r['hashes'])} steps hashed")
        if r["launches"] != expected or r["heads"] != heads:
            raise AssertionError(f"FSDP {name} rank {i} launches {r['launches']} heads {r['heads']}, expected "
                                 f"{expected} at {heads}")
        layout = r["layout_bytes"]
        if (r["param_bytes"], r["moment_bytes"]) != (layout["params"], layout["moments"]) \
                or layout["whole"] != ref["param_bytes"]:
            raise AssertionError(f"FSDP {name} rank {i}: parameter and moment bytes {r['param_bytes']}, "
                                 f"{r['moment_bytes']}; the layout gives {layout} (world 1 {ref['param_bytes']})")
    for m in range(tp):  # a 'data' line: the same parameters gathered, other slices
        line = [per_rank[d * tp + m]["hashes"] for d in range(dp)]
        for step, first in enumerate(line[0]):
            if any(x[step]["gathered"] != first["gathered"] for x in line):
                raise AssertionError(f"FSDP {name} step {step}: the gathered parameters differ along 'data'")
            for x in line[1:]:
                if any(s and a == b for s, a, b in zip(first["sliced"], first["all"], x[step]["all"])):
                    raise AssertionError(f"FSDP {name} step {step}: a rank holds its 'data' peer's slice")
    rel = max(abs(a - b) / abs(b) for a, b in zip(per_rank[0]["losses"], ref["losses"]))
    if rel > TOL_TP_LOSS_REL:
        raise AssertionError(f"FSDP {name} losses {per_rank[0]['losses']} against world 1's {ref['losses']} "
                             f"(limit {TOL_TP_LOSS_REL} relative)")


def phase_train_fsdp(smi: str, world1: dict) -> tuple:
    """ZeRO-3/FSDP training on the card through `train.main --fsdp`, against
    phase_train_tp's world-1 runs (`world1`; the same data, blocks and
    steps, not run again): DP-2 on 2 ranks, a full fine-tune of
    TP_TRAINABLE, and TP-2 x DP-2 on 4, LoRA rank 16 on the fp8 base with
    --save (`spawn_ranks`). Fails unless each rank's losses are within
    TOL_TP_LOSS_REL of world 1's, after each step the ranks of each 'data'
    line hold the same parameters gathered and other slices, each rank's
    parameter and moment bytes are what the FSDP rule gives from world 1's
    leaves, the K1 / K3 launches are as reckoned with TP_HEADS / TP heads
    each, and only rank 0 writes the --save file, whose names and shapes
    are world 1's. Returns (record, the K1 / K3 launches by path, summed
    over the ranks)."""
    import datetime
    import os
    import tempfile

    import torch

    from ltx2_tpu_torch.parallel.runtime import spawn_ranks

    t_phase = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="ltx2_train_fsdp_")
    try:
        npz = _tp_npz(directory)
        record, counts = {"world_1_param_bytes": {("lora_fp8" if k else "trainable"): r["param_bytes"]
                                                  for k, r in world1["runs"].items()}, "routes": {}}, {}
        for backend in ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 4 else []):
            out = {}
            for world in (2, 4):
                jobs = [k for k, (tp, dp, _) in FSDP_TRAIN_CONFIGS.items() if tp * dp == world]
                t0 = time.perf_counter()
                ranks = spawn_ranks(_train_fsdp_rank, world, os.path.join(directory, f"{backend}{world}"), npz,
                                    directory, jobs, backend=backend, device="cuda", timeout=FSDP_TRAIN_TIMEOUT_S,
                                    collective_timeout=datetime.timedelta(seconds=FSDP_TRAIN_TIMEOUT_S))
                out[f"wall_s_world_{world}"] = time.perf_counter() - t0
                for name in jobs:
                    tp, dp, lora = FSDP_TRAIN_CONFIGS[name]
                    per_rank, ref = [r[name] for r in ranks], world1["runs"][lora]
                    rec = {"ranks": [{k: r[k] for k in ("losses", "step_s", "peak_gb", "param_bytes", "moment_bytes",
                                                        "layout_bytes", "bytes_by_route", "bytes_by_axis",
                                                        "last_step_bytes", "last_step_op_bytes", "launches",
                                                        "heads", "seconds")} for r in per_rank],
                           "world_1_losses": ref["losses"], "world_1_param_bytes": ref["param_bytes"],
                           "world_1_moment_bytes": ref["moment_bytes"],
                           "loss_rel_err_vs_world_1": max(abs(a - b) / abs(b) for a, b in
                                                          zip(per_rank[0]["losses"], ref["losses"])),
                           "launches_expected_per_rank": _tp_expected()}
                    log(f"train FSDP over {backend}, {name} (TP {tp} x DP {dp}, {TP_TRAIN_LAYERS} layers, batch "
                        f"{TP_TRAIN_BATCH}): {json.dumps(rec)} | {smi}")
                    _fsdp_checks(name, per_rank, ref, tp, dp)
                    if lora:
                        path = f"{directory}/{name}.safetensors"
                        writes, calls = [r["writes"] for r in per_rank], [r["calls"] for r in per_rank]
                        if writes != [[path]] + [[]] * (world - 1) or calls != [[path]] * world:
                            raise AssertionError(f"FSDP LoRA --save: writes by rank {writes}, exports by rank {calls}")
                        if _safetensors_shapes(path) != world1["lora_shapes"]:
                            raise AssertionError("FSDP LoRA --save: the file's names or shapes are not world 1's")
                        os.remove(path)
                    out[name] = rec
                    counts[f"train_fsdp_{backend}_{name}"] = {k: sum(r["launches"][k] for r in per_rank)
                                                              for k in ("fwd", "bwd")}
            record["routes"][backend] = out
        record["seconds"] = time.perf_counter() - t_phase
        log(f"train FSDP phase: {record['seconds']:.1f} s, launches {json.dumps(counts)} | {smi}")
        return record, counts
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# int8 W8A8 serving (phase 5b). The JAX package asks the int8 x0 to correlate
# with bf16's above 0.999 on random weights (tests/test_int8.py:216).
INT8_CORR_MIN = 0.999
INT8_CKPT_LAYERS = 2
# The int8 product's launches a DiT step: 10 quantized linears a V1 block
# (attn1's and attn2's q, k, v and out, the FFN's two).
INT8_LINEARS_PER_BLOCK = 10


def _x0(dit, seed: int):
    """One x0 forward of `dit` at 512x768x121 (6144 tokens) on a request
    drawn from `seed` at sigma 0.75, fp32 out."""
    import torch

    from ltx2_tpu_torch.generate import make_latent_tools, make_request
    from ltx2_tpu_torch.models.transformer.model import x0_model_apply
    from ltx2_tpu_torch.pipelines.common import modality_from_state

    dev = torch.device("cuda")
    tools = make_latent_tools(dit.cfg, HEIGHT, WIDTH, FRAMES)
    state, context = make_request(dit.cfg, tools, seed, dev)
    with torch.no_grad():
        modality = modality_from_state(state, context, torch.tensor(0.75, device=dev), uniform_timesteps=True)
        return x0_model_apply(dit, modality).float()


def _correlation(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a @ b) / (a.norm() * b.norm()))


def phase_int8(dit, smi: str) -> tuple:
    """int8 W8A8 serving on the full-width bf16 DiT of phase 5's step,
    quantized in place on the card as `quantize_params_int8` does: the
    seconds and peak of the quantization, the weights' GB, the x0 of one
    6144-token forward against the bf16 DiT's on the same weights (relative
    rms and correlation, > 0.999 as the JAX package asks), the traced step
    (`denoise_step`, beside the fp8 and bf16 ones) and its peak; the
    torch._int_mm route bit for bit the plain int32 route on the same codes
    at the DiT's shapes (to_q 6144 x 4096 -> 4096, the text K 1024 x 4096,
    the FFN's 6144 x 16384 -> 4096), its time beside the bf16 product's,
    and a shape outside its contract refused; a 2-block full-width
    checkpoint written in bf16 and streamed with `quantize_int8` (host
    quantization) equal bit for bit to the same file loaded and quantized
    on the card; then bench-e2e's loop (`generate_videos(dit=...)`, one
    request, 8 steps) on the int8 DiT: 768 flash and 3840 int8 launches.
    Returns (the record with the step's under "step", the serving path's
    launch counts)."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.generate import generate_videos, make_dit
    from ltx2_tpu_torch.loader.export import export_transformer_checkpoint
    from ltx2_tpu_torch.loader.fp8 import weight_bytes
    from ltx2_tpu_torch.loader.int8 import quantize_params_int8
    from ltx2_tpu_torch.loader.weight_loader import load_transformer_params
    from ltx2_tpu_torch.ops import common
    from ltx2_tpu_torch.profile_slice import denoise_step

    dev, card = torch.device("cuda"), torch.cuda.get_device_name(0)
    ref = _x0(dit, 5)
    rec = {"bf16_weight_gb": weight_bytes(dit) / 1e9, "card": smi}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_params_int8(dit)
    torch.cuda.synchronize()
    rec.update(quantize_s=time.perf_counter() - t0, quantize_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               weight_gb=weight_bytes(dit) / 1e9)
    got = _x0(dit, 5)
    rec["x0_vs_bf16"] = {"rms_rel": ((got - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item(),
                         "correlation": _correlation(got, ref), "finite": bool(torch.isfinite(got).all()),
                         "correlation_min": INT8_CORR_MIN}
    del got, ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rec["step"] = denoise_step(dit, HEIGHT, WIDTH, "denoise_step_int8", dev, card)[1]
    rec["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    gen = torch.Generator(device=dev).manual_seed(6)
    block = dit.transformer_blocks[0]
    rec["int_mm"] = {}
    for name, lin, rows in (("to_q", block.attn1.to_q, 6144), ("text_to_k", block.attn2.to_k, 1024),
                            ("ff_out", block.ff.project_out, 6144)):
        x = torch.randn(rows, lin.weight.shape[1], device=dev, generator=gen).bfloat16()
        x_q, _ = common.quantize_activations_int8(x)
        w_bf16 = common.dequantize_int8(lin, torch.bfloat16)
        rec["int_mm"][name] = {
            "shape": [rows, lin.weight.shape[1], lin.weight.shape[0]],
            "bitwise_plain": bool(torch.equal(common.int8_matmul(x_q, lin.weight),
                                              common.int8_matmul_plain(x_q, lin.weight))),
            "w8a8_ms": _time_ms(lambda: common.w8a8_matmul(x, lin.weight, lin.weight_cscale), 20),
            "int_mm_ms": _time_ms(lambda: common.int8_matmul(x_q, lin.weight), 20),
            "bf16_linear_ms": _time_ms(lambda: F.linear(x, w_bf16), 20)}
    try:
        common.int8_matmul(x_q[:16], lin.weight)
    except ValueError:
        rec["int_mm"]["16_rows_refused"] = True
    else:
        raise AssertionError("torch._int_mm's route took 16 rows")

    directory = tempfile.mkdtemp(prefix="ltx2_int8_")
    try:
        small = make_dit(INT8_CKPT_LAYERS, dev, seed=11)
        path = f"{directory}/dit.safetensors"
        export_transformer_checkpoint(path, small, dtype=torch.bfloat16)
        del small
        t0 = time.perf_counter()
        streamed = load_transformer_params(path, device=dev, quantize_int8=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        on_card = quantize_params_int8(load_transformer_params(path, device=dev)).state_dict()
        leaves = streamed.state_dict()
        differ = [n for n, t in leaves.items() if t.dtype != on_card[n].dtype
                  or not torch.equal(t.reshape(-1).view(torch.uint8), on_card[n].reshape(-1).view(torch.uint8))]
        rec["streamed_checkpoint"] = {"blocks": INT8_CKPT_LAYERS, "load_s": load_s, "differ": differ,
                                      "int8_weights": sum(t.dtype == torch.int8 for t in leaves.values())}
        del streamed, on_card, leaves
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    common.int_mm_launches.clear()
    _reset_counts()
    t0 = time.perf_counter()
    latents, stats = generate_videos([SEEDS[0]], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=STEPS,
                                     device="cuda", dit=dit, skip_decode=True)
    counts = {**_counts(), "int_mm": sum(common.int_mm_launches.values())}
    rec["serve"] = {"denoise_s": stats[0]["denoise_s"], "wall_s": time.perf_counter() - t0,
                    "latent_finite": stats[0]["latent_finite"], "launches": counts,
                    "int_mm_shapes": sorted(common.int_mm_launches)}
    log(f"int8 W8A8 ({LAYERS} layers): {json.dumps(rec)} | {smi}")
    x0 = rec["x0_vs_bf16"]
    if not (x0["finite"] and x0["correlation"] > INT8_CORR_MIN):
        raise AssertionError(f"int8 x0 against bf16: {x0}")
    if not all(r["bitwise_plain"] for r in rec["int_mm"].values() if isinstance(r, dict)):
        raise AssertionError(f"torch._int_mm against the plain int32 route: {rec['int_mm']}")
    ckpt = rec["streamed_checkpoint"]
    if ckpt["differ"] or ckpt["int8_weights"] != INT8_LINEARS_PER_BLOCK * INT8_CKPT_LAYERS:
        raise AssertionError(f"int8 quantized at load against on the card: {ckpt}")
    want = {"fwd": LAUNCHES_PER_CLIP, "bwd": 0, "conv": 0, "int_mm": INT8_LINEARS_PER_BLOCK * LAYERS * STEPS}
    if counts != want or not stats[0]["latent_finite"] or latents[0].shape != (1, 128, 16, 16, 24):
        raise AssertionError(f"int8 serving path: launches {counts} (expected {want}), {stats[0]}")
    return rec, counts


TEMPORAL_LATENT = (1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32)
# `generate.main --pipeline one-stage --upscale-temporal` at a small size:
# random full-width modules, 2 blocks.
TEMPORAL_CLI = {"layers": 2, "height": 128, "width": 128, "frames": 17, "steps": 2}


def phase_temporal_upscale(smi: str) -> tuple:
    """The full-width temporal upscaler (hidden 512, 4 + 4 res blocks, fp32,
    random weights) on a 512x768x121 latent (16 x 16 x 24): 31 frames out,
    the card against the CPU within 1e-5 rms and 1e-4 max relative, 19 fp32
    conv launches, the call's time (CUDA events) and peak, the conv cases'
    times x launches beside one traced call's conv time; then
    `generate.main --pipeline one-stage --upscale-temporal` at 2 blocks,
    128x128x17: 3 latent frames become 5, a .y4m of 33 frames. Returns (the
    record, the CLI path's launch counts: flash, fp32 and bf16 convs)."""
    import shutil
    import tempfile

    import torch

    from ltx2_tpu_torch import generate
    from ltx2_tpu_torch.models.upscaler.card_check import temporal_upscaler_against_cpu
    from ltx2_tpu_torch.models.upscaler.temporal import temporal_upscaler_apply
    from ltx2_tpu_torch.utils.video_io import y4m_header

    dev = torch.device("cuda")
    up = generate.make_temporal_upscaler(dev)
    latent = torch.randn(TEMPORAL_LATENT, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    _reset_counts()
    rec = {"card_vs_cpu": temporal_upscaler_against_cpu(up, latent), "card": smi}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec["ms"] = _time_ms(lambda: temporal_upscaler_apply(up, latent), 3)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    traced = _device_ms(lambda: temporal_upscaler_apply(up, latent), 1)
    rec["traced_conv_ms"] = sum(ms for n, (ms, _) in traced.items() if "conv3d_tf32x3" in n) or None
    del up, latent
    torch.cuda.empty_cache()

    c = TEMPORAL_CLI
    directory = tempfile.mkdtemp(prefix="ltx2_temporal_")
    try:
        out = f"{directory}/clip.y4m"
        _reset_counts()
        videos, stats = generate.main([
            "--pipeline", "one-stage", "--device", "cuda", "--layers", str(c["layers"]), "--height", str(c["height"]),
            "--width", str(c["width"]), "--frames", str(c["frames"]), "--num-inference-steps", str(c["steps"]),
            "--upscale-temporal", "--output", out])
        counts = _counts()
        frames = 8 * (2 * ((c["frames"] - 1) // 8 + 1) - 2) + 1
        y4m_bytes = len(y4m_header(c["width"], c["height"], 24.0)) + frames * (6 + 3 * c["height"] * c["width"])
        import os

        rec["cli"] = {"frames": list(videos[0].shape), "y4m_bytes": os.path.getsize(out), "expected_frames": frames,
                      "launches": counts, "upscale_temporal_conv_launches": stats[0]["upscale_temporal_conv_launches"],
                      "upscale_temporal_s": stats[0]["upscale_temporal_s"]}
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log(f"temporal upscaler: {json.dumps(rec)} | {smi}")
    check = rec["card_vs_cpu"]
    if not check["ok"] or check["out_shape"] != [1, 128, 2 * TEMPORAL_LATENT[2] - 1, *TEMPORAL_LATENT[3:]]:
        raise AssertionError(f"temporal upscaler on the card against the CPU: {check}")
    cli = rec["cli"]
    flash = 2 * c["layers"] * c["steps"]  # self and text attention a block a step, the CFG rows batched
    if (cli["frames"] != [frames, c["height"], c["width"], 3] or cli["y4m_bytes"] != y4m_bytes
            or cli["upscale_temporal_conv_launches"] != 19 or counts["fwd"] != flash or counts["bwd"]):
        raise AssertionError(f"--upscale-temporal: {cli}, expected {frames} frames, {y4m_bytes} bytes, {flash} flash")
    return rec, {"fwd": counts["fwd"], "conv_fp32": 19, "conv_bf16": counts["conv"] - 19}


KEYFRAME_STEPS = 4  # stage 1 cut from the config's 30
KEYFRAME_FRAMES = (0, FRAMES - 1)
HQ_STEPS = 4  # the Res2s stage 1 cut from the config's 15
HQ_AV_LAYERS = 2


def _flash_by_length() -> dict:
    from ltx2_tpu_torch.ops.attention import flash_attention

    return {f"{q}x{k}": n for (q, k), n in sorted(flash_attention.launches_by_length.items())}


def phase_keyframe_and_hq(smi: str) -> tuple:
    """Keyframe interpolation and ti2vid-hq at full width and depth (the
    random 48-block bf16 DiT, the fp32 encoder and upscaler, the bf16
    decoder, built once and handed to both flows), 512x768x121, one request
    each: (a) `generate_videos_keyframe` with two PNG keyframes at frames 0
    (strength 1.0) and 120 (0.95), stage 1 at 4 CFG steps (cut from 30),
    stage 2 at 3, the decode: 121 frames, flash launches by length (stage
    1's 1728 tokens at batch 2, stage 2's 6912), the encoder's, the
    upscaler's and the decode's conv launches, and the strength-1.0
    keyframe's appended tokens bit for bit their clean latent at each
    stage's end (the 0.95 keyframe's must move); (b)
    `generate_videos_ti2vid_hq` with the first PNG at frame 0: the Res2s
    stage 1 at 4 steps (two guided evaluations a step, batch 2), stage 2,
    the decode; (c) ti2vid-hq with `--audio` on the random fp8 AV DiT at 2
    blocks (skip_decode): flash at head dim 64. Returns (the record, the
    launch counts of the keyframe, ti2vid-hq and ti2vid-hq AV paths)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ltx2_tpu_torch import generate
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.pipelines.common import ImageCondition
    from ltx2_tpu_torch.pipelines.keyframe_interpolation import Keyframe

    dev = torch.device("cuda")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    enc, ups, dec = (encoder_convs(VideoEncoderConfig()), upscaler_convs(SpatialUpscalerConfig()),
                     decoder_convs(VideoDecoderConfig()) * tiles)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    modules = {"dit": generate.make_dit(LAYERS, dev), "encoder": generate.make_encoder(dev),
               "upscaler": generate.make_upscaler(dev), "decoder": generate.make_decoder("bfloat16", dev)}
    torch.cuda.synchronize()
    rec, counts = {"init_s": time.perf_counter() - t0, "card": smi}, {}
    directory = tempfile.mkdtemp(prefix="ltx2_keyframe_")
    try:
        first = _write_png(f"{directory}/first.png", IMAGE_SEED, IMAGE_SIZE)
        last = _write_png(f"{directory}/last.png", IMAGE_SEED + 1, (HEIGHT, WIDTH))
        keyframes = [Keyframe(first, KEYFRAME_FRAMES[0], 1.0), Keyframe(last, KEYFRAME_FRAMES[1], 0.95)]
        ends = []
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        flash_attention.launches_by_length = {}
        frames, stats = generate.generate_videos_keyframe(
            [SEEDS[0]], keyframes, height=HEIGHT, width=WIDTH, frames=FRAMES, steps=KEYFRAME_STEPS, device="cuda",
            phase_peaks=True, end_states=ends, **modules)
        counts["keyframe"] = {**_counts(), "by_length": _flash_by_length()}
        st = stats[0]
        phases = ("stage1", "upscale", "stage2", "decode")
        kf = {"seconds": {p: st[f"{p}_s"] for p in phases}, "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
              "conv_launches": {p: st[f"{p}_conv_launches"] for p in phases[:-1]},
              "decode_conv_launches": st["decode_conv_launches"], "frames": list(frames[0].shape),
              "launches": counts["keyframe"], "exact": []}
        for state, tokens in zip(ends, (((FRAMES - 1) // 8 + 1) * (HEIGHT // 64) * (WIDTH // 64),
                                        ((FRAMES - 1) // 8 + 1) * (HEIGHT // 32) * (WIDTH // 32))):
            per = (state.latent.shape[1] - tokens) // 2  # each keyframe's tokens
            sl = [slice(tokens + i * per, tokens + (i + 1) * per) for i in range(2)]
            kf["exact"].append([bool(torch.equal(state.latent[:, s], state.clean_latent[:, s])) for s in sl])
        rec["keyframe"] = kf
        log(f"keyframe interpolation ({WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, keyframes at "
            f"{KEYFRAME_FRAMES}, stage 1 {KEYFRAME_STEPS} steps, stage 2 3): {json.dumps(kf)} | {smi}")
        s1, s2 = 1536 + 2 * 96, 6144 + 2 * 384
        want_len = {f"{s1}x{s1}": LAYERS * KEYFRAME_STEPS, f"{s1}x1024": LAYERS * KEYFRAME_STEPS,
                    f"{s2}x{s2}": LAYERS * 3, f"{s2}x1024": LAYERS * 3}
        want_conv = {"stage1": enc * 2, "upscale": ups, "stage2": enc * 2}
        if (kf["frames"] != [FRAMES, HEIGHT, WIDTH, 3] or kf["launches"]["by_length"] != want_len
                or kf["conv_launches"] != want_conv or kf["decode_conv_launches"] != dec
                or kf["exact"] != [[True, False], [True, False]]
                or not all(st[f"{p}_latent_finite"] for p in phases[:-1])):
            raise AssertionError(f"keyframe interpolation: {kf}, expected flash {want_len}, convs {want_conv}, "
                                 f"decode {dec}, the strength-1.0 keyframe exact and the 0.95 one moved")

        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        _reset_flash_by()
        flash_attention.launches_by_length = {}
        frames, stats = generate.generate_videos_ti2vid_hq(
            [SEEDS[0]], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=HQ_STEPS, device="cuda", phase_peaks=True,
            images=[ImageCondition(first, 0, IMAGE_STRENGTH)], **modules)
        counts["ti2vid_hq"] = {**_counts(), "by_batch": _flash_by("launches_by_batch")}
        st = stats[0]
        hq = {"seconds": {p: st[f"{p}_s"] for p in phases}, "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
              "stage1_step_s": st["stage1_step_s"], "conv_launches": {p: st[f"{p}_conv_launches"] for p in phases[:-1]},
              "decode_conv_launches": st["decode_conv_launches"], "frames": list(frames[0].shape),
              "launches": counts["ti2vid_hq"]}
        rec["ti2vid_hq"] = hq
        log(f"ti2vid-hq ({WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, image at frame 0, Res2s stage 1 {HQ_STEPS} "
            f"steps): {json.dumps(hq)} | {smi}")
        want_batch = {2: 2 * 2 * LAYERS * HQ_STEPS, 1: 2 * LAYERS * 3}
        if (hq["frames"] != [FRAMES, HEIGHT, WIDTH, 3] or hq["launches"]["by_batch"] != want_batch
                or hq["conv_launches"] != {"stage1": enc, "upscale": ups, "stage2": enc}
                or hq["decode_conv_launches"] != dec or not all(st[f"{p}_latent_finite"] for p in phases[:-1])):
            raise AssertionError(f"ti2vid-hq: {hq}, expected flash by batch {want_batch}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del modules
    torch.cuda.empty_cache()

    _reset_counts()
    _reset_flash_by()
    latents, stats = generate.generate_videos_ti2vid_hq(
        [SEEDS[0]], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=HQ_STEPS, layers=HQ_AV_LAYERS, device="cuda",
        audio=True, skip_decode=True)
    counts["ti2vid_hq_av"] = {**_counts(), "by_head_dim": _flash_by("launches_by_head_dim")}
    video, audio = latents[0]
    rec["ti2vid_hq_av"] = {"layers": HQ_AV_LAYERS, "latent": list(video.shape), "audio_latent": list(audio.shape),
                           "finite": bool(np.isfinite(video).all() and np.isfinite(audio).all()),
                           "stage1_s": stats[0]["stage1_s"], "launches": counts["ti2vid_hq_av"]}
    log(f"ti2vid-hq with audio ({HQ_AV_LAYERS} AV blocks): {json.dumps(rec['ti2vid_hq_av'])} | {smi}")
    evals = 2 * HQ_STEPS + 3  # stage 1's two evaluations a step, stage 2's one
    want_dim = {64: 4 * HQ_AV_LAYERS * evals, 128: 2 * HQ_AV_LAYERS * evals}
    if not rec["ti2vid_hq_av"]["finite"] or counts["ti2vid_hq_av"]["by_head_dim"] != want_dim \
            or list(audio.shape) != [1, 8, AV_AUDIO_TOKENS, 16]:
        raise AssertionError(f"ti2vid-hq with audio: {rec['ti2vid_hq_av']}, expected flash by head dim {want_dim}")
    torch.cuda.empty_cache()
    return rec, counts


# ---- the video readers, retake, ic-lora and prepare_data --videos -------------

FIXTURE_DIR = "tests/fixtures_video"
FIXTURE_AVI, FIXTURE_JPG = "pattern_288x432x9.avi", "pattern_512x768.jpg"
RETAKE = {"steps": 4, "cfg_scale": 3.0, "start": 1.0, "end": 3.0}  # steps cut from the config's 30
IC_LORA_RANK = 64
IC_SMALL = {"layers": 2, "height": 256, "width": 384, "frames": 25}


def _fixture(name: str) -> tuple:
    """A committed fixture's path and its recorded hashes."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / FIXTURE_DIR / name
    return str(path), json.loads(path.with_suffix(".json").read_text())


def _sha256(array) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def _write_source_y4m(path: str, frames: int, height: int, width: int, seed: int = 12) -> None:
    """A 24 fps clip of moving sinusoids with noise, through the port's
    `write_y4m` (C444)."""
    import numpy as np

    from ltx2_tpu_torch.utils.video_io import write_y4m

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    clip = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        rgb = np.stack([np.sin(2 * np.pi * (xx / width + 0.01 * t)), np.cos(2 * np.pi * (yy / height - 0.008 * t)),
                        np.sin(2 * np.pi * ((xx + yy) / (width + height) + 0.006 * t))], -1)
        clip[t] = np.clip(128 + 100 * rgb + rng.normal(0, 6, rgb.shape), 0, 255).astype(np.uint8)
    write_y4m(path, clip, 24.0)


def phase_readers(smi: str, source: str) -> dict:
    """The committed fixtures through the port's readers on the card's host:
    the MJPEG AVI's 9 frames decoded by `decode_jpeg` (the SHA-256 of PIL's
    decode, recorded beside the file), `read_avi_mjpeg` at 256x384x121 (the
    JAX reader's SHA-256), the 512x768 JPEG still (PIL's SHA-256); host
    seconds a frame of the JPEG decoder at 288x432 and 512x768 and of
    `read_y4m` on the 512x768x121 retake source."""
    from ltx2_tpu_torch.pipelines.common import read_image
    from ltx2_tpu_torch.utils.jpeg import decode_jpeg
    from ltx2_tpu_torch.utils.video_io import _avi_chunks, read_avi_mjpeg, read_y4m

    import numpy as np

    avi, avi_meta = _fixture(FIXTURE_AVI)
    jpg, jpg_meta = _fixture(FIXTURE_JPG)
    with open(avi, "rb") as fh:
        data = fh.read()
    payloads = [data[o:o + n] for fourcc, o, n in _avi_chunks(data) if fourcc == b"00dc"]
    t0 = time.perf_counter()
    frames = np.stack([decode_jpeg(p) for p in payloads])
    jpeg_288 = (time.perf_counter() - t0) / len(payloads)
    t0 = time.perf_counter()
    packed = read_avi_mjpeg(avi, 256, 384, 121)
    avi_read = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        still = read_image(jpg)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    y4m = read_y4m(source, HEIGHT, WIDTH, FRAMES)
    y4m_s = time.perf_counter() - t0
    rec = {"fixture_frames": list(frames.shape),
           "fixture_sha_equal": _sha256(frames) == avi_meta["sha256_pil_frames_uint8"],
           "read_avi_mjpeg_256x384x121_sha_equal":
               _sha256(packed) == avi_meta["sha256_read_avi_mjpeg_256x384x121_float32"],
           "still_sha_equal": _sha256(still) == jpg_meta["sha256_pil_rgb_uint8"],
           "jpeg_decode_s_per_frame": {"288x432": jpeg_288, "512x768": min(times)},
           "read_avi_mjpeg_256x384x121_s": avi_read,
           "read_y4m_s_per_frame_512x768": y4m_s / FRAMES, "read_y4m_shape": list(y4m.shape), "card": smi}
    log(f"video readers (host): {json.dumps(rec)}")
    if not (rec["fixture_sha_equal"] and rec["read_avi_mjpeg_256x384x121_sha_equal"] and rec["still_sha_equal"]):
        raise AssertionError(f"video readers: a decode differs from the recorded SHA-256: {rec}")
    if rec["read_y4m_shape"] != [1, 3, FRAMES, HEIGHT, WIDTH] or not np.isfinite(y4m).all():
        raise AssertionError(f"read_y4m: {rec['read_y4m_shape']}")
    return rec


MEDIA_JSON = "media_io.json"
FIXTURE_GIF, FIXTURE_APNG = "gif_96x144x9.gif", "apng_96x144x9.apng"
CANNY_THRESHOLDS = ((20, 60), (100, 200))
AV_MJPEG = {"layers": 2, "height": 256, "width": 384, "frames": 25}


def _fixture_audio(frames: int = 9, rate: int = 24000, fps: float = 24.0):
    """tests/torch_port_media.py's `fixture_audio`: two sawtooths of
    integers, (2, N) float32."""
    import numpy as np

    n = int(round(frames / fps * rate))
    i = np.arange(n, dtype=np.int64)
    return np.stack([((i * 37) % 2001 - 1000) / 1000.0, ((i * 11) % 1201 - 600) / 640.0]).astype(np.float32)


def _write_apng(path: str, frames) -> None:
    """RGB frames as an 8-bit APNG (filter 0, dispose and blend 0): the
    card's machine has no PIL to write one."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    n, h, w, _ = frames.shape
    out = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           chunk(b"acTL", struct.pack(">II", n, 0))]
    seq = 0
    for i, frame in enumerate(frames):
        out.append(chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, 24, 0, 0)))
        seq += 1
        raw = zlib.compress(np.concatenate([np.zeros((h, 1), np.uint8), frame.reshape(h, -1)], axis=1).tobytes(), 6)
        out.append(chunk(b"IDAT", raw) if i == 0 else chunk(b"fdAT", struct.pack(">I", seq) + raw))
        seq += i > 0
    out.append(chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def _host_ms(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return 1000 * best


def phase_media_io(smi: str, directory: str) -> dict:
    """The port's media I/O on the card's host against the hashes
    tests/fixtures_video/media_io.json records with PIL, OpenCV and the JAX
    writers: the JPEGs of the committed AVI's 9 frames (as the port decodes
    them) at quality 92, the .avi, .mp4 and .mov of those frames without and
    with `_fixture_audio()`, the committed GIF's and APNG's frames, the Canny
    signal of the AVI's frames at 256x384 (20 / 60 and 100 / 200); then host
    ms per 512x768 frame of `encode_jpeg` (one call, and `encode_jpegs`'
    pool over 8 frames, and once over 121), `decode_jpeg`, `write_gif`, `decode_gif` (its own
    literal-coded file), `read_apng` (an APNG written here) and the Canny
    (LANCZOS4 from 288x432, gray, Canny)."""
    import hashlib
    import os

    import numpy as np

    from ltx2_tpu_torch.pipelines.common import read_image
    from ltx2_tpu_torch.utils import video_io as vio
    from ltx2_tpu_torch.utils.canny import bgr_to_gray, canny, resize_lanczos4
    from ltx2_tpu_torch.utils.gif import decode_gif, write_gif
    from ltx2_tpu_torch.utils.image_io import read_apng
    from ltx2_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg, encode_jpegs

    avi, _ = _fixture(FIXTURE_AVI)
    meta = json.loads(open(os.path.join(os.path.dirname(avi), MEDIA_JSON), encoding="utf-8").read())
    with open(avi, "rb") as fh:
        data = fh.read()
    frames = np.stack([decode_jpeg(data[o:o + n]) for fourcc, o, n in vio._avi_chunks(data) if fourcc == b"00dc"])
    audio = _fixture_audio()
    checks = {"avi_frames": _sha256(frames) == meta["avi_frames_sha256"],
              "audio": _sha256(audio) == meta["audio"]["sha256_float32"],
              "jpeg_q92": [hashlib.sha256(encode_jpeg(f)).hexdigest() for f in frames] == meta["jpeg_q92_sha256"]}
    for key, want in meta["writers"].items():
        suffix = key.split("_")[0]
        path = os.path.join(directory, f"media.{suffix}")
        writer = vio.write_avi_mjpeg if suffix == "avi" else vio.write_mp4_mjpeg
        writer(path, frames, 24.0, audio=audio if key.endswith("_audio") else None, sample_rate=24000)
        with open(path, "rb") as fh:
            checks[f"writer_{key}"] = hashlib.sha256(fh.read()).hexdigest() == want
    gif_path = os.path.join(os.path.dirname(avi), FIXTURE_GIF)
    with open(gif_path, "rb") as fh:
        checks["gif_frames"] = _sha256(np.stack(decode_gif(fh.read()))) == meta["gif"]["sha256_pil_frames_uint8"]
    apng_path = os.path.join(os.path.dirname(avi), FIXTURE_APNG)
    checks["apng_frames"] = _sha256(np.stack(read_apng(apng_path))) == meta["apng"]["sha256_pil_frames_uint8"]
    checks["probes"] = (list(vio.probe_video(gif_path)), list(vio.probe_video(apng_path))) == \
        ([25.0, 9, 96, 144], [25.0, 9, 96, 144])
    for low, high in CANNY_THRESHOLDS:
        signal = np.stack([np.repeat(canny(bgr_to_gray(resize_lanczos4(f[..., ::-1], 384, 256)), low, high)[..., None],
                                     3, axis=2) for f in frames])
        checks[f"canny_{low}_{high}"] = _sha256(signal) == meta["canny"][f"{low}_{high}"]["sha256_uint8"]

    # Host ms per 512x768 frame: the committed still, shifted a little per frame.
    still = read_image(_fixture(FIXTURE_JPG)[0])
    clip = np.stack([np.roll(still, 7 * i, axis=1) for i in range(8)])
    long_clip = np.stack([np.roll(still, 7 * i, axis=1) for i in range(FRAMES)])  # a served clip's count
    jpeg_bytes = encode_jpeg(clip[0])
    gif_out = os.path.join(directory, "media.gif")
    write_gif(gif_out, clip[:2], 41)  # scipy's import outside the timing
    t0 = time.perf_counter()
    write_gif(gif_out, clip, 41)
    gif_write_ms = 1000 * (time.perf_counter() - t0) / len(clip)
    with open(gif_out, "rb") as fh:
        gif_bytes = fh.read()
    apng_out = os.path.join(directory, "media.apng")
    _write_apng(apng_out, clip[:4])
    bgr = frames[0][..., ::-1]
    ms = {"encode_jpeg": _host_ms(lambda: encode_jpeg(clip[0])),
          "encode_jpegs_8_frames_per_frame": _host_ms(lambda: encode_jpegs(clip)) / len(clip),
          "encode_jpegs_121_frames_per_frame": _host_ms(lambda: encode_jpegs(long_clip), repeats=1) / len(long_clip),
          "decode_jpeg": _host_ms(lambda: decode_jpeg(jpeg_bytes)),
          "write_gif": gif_write_ms,
          "decode_gif_literal_codes": _host_ms(lambda: decode_gif(gif_bytes, max_frames=2), repeats=1) / 2,
          "read_apng": _host_ms(lambda: read_apng(apng_out), repeats=1) / 4,
          "canny_288x432_to_512x768": _host_ms(lambda: canny(bgr_to_gray(resize_lanczos4(bgr, 768, 512)), 20, 60))}
    rec = {"checks": checks, "ms_per_512x768_frame": ms, "jpeg_bytes_512x768": len(jpeg_bytes),
           "gif_bytes_per_512x768_frame": len(gif_bytes) / len(clip), "card": smi}
    log(f"media I/O (host): {json.dumps(rec)}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"media I/O: {bad} differ from tests/fixtures_video/{MEDIA_JSON}")
    return rec


def phase_ic_lora_canny(smi: str, directory: str, raw_counts: dict) -> tuple:
    """`generate.main --pipeline ic-lora --control-type canny --canny-low 20
    --canny-high 60 --save-control` at full width and depth, 512x768x121,
    on a copy of the committed AVI and phase_ic_lora's IC-LoRA file: the
    control read by the port's readers (OpenCV hidden when this machine has
    it: its FFmpeg decode of the AVI is not PIL's), the port's Canny
    at stage 1's 256x384 over 121 frames (its first 9 frames against
    OpenCV's recorded hash, the rest the last repeated), the
    `.control.avi` against the JAX writer's recorded bytes of that signal,
    the launches those of the RAW run. Then, where this machine has OpenCV,
    the route a run takes with it (`_canny_opencv_route`)."""
    import hashlib
    import importlib.util
    import os
    import shutil

    import numpy as np
    import torch

    from ltx2_tpu_torch import generate as G
    from ltx2_tpu_torch.pipelines import ic_lora

    avi, _ = _fixture(FIXTURE_AVI)
    meta = json.loads(open(os.path.join(os.path.dirname(avi), MEDIA_JSON), encoding="utf-8").read())
    control = os.path.join(directory, "canny_control.avi")
    shutil.copy(avi, control)
    signals = []
    real = ic_lora.preprocess_canny

    def recorded(*args, **kwargs):
        t0 = time.perf_counter()
        signal = real(*args, **kwargs)
        signals.append((signal, time.perf_counter() - t0))
        return signal

    low, high = CANNY_THRESHOLDS[0]
    out = os.path.join(directory, "ic_lora_canny.y4m")
    torch.cuda.empty_cache()
    _reset_counts()
    _reset_flash_by()
    _counters()["fwd"].launches_by_length = {}
    opencv = "cv2" in sys.modules or importlib.util.find_spec("cv2") is not None
    hidden = sys.modules.get("cv2")
    ic_lora.preprocess_canny, sys.modules["cv2"] = recorded, None
    try:
        t0 = time.perf_counter()
        videos, stats = G.main(["--pipeline", "ic-lora", "--control-video", control, "--control-type", "canny",
                                "--canny-low", str(low), "--canny-high", str(high), "--save-control",
                                "--ic-lora-weights", os.path.join(directory, "ic_lora.safetensors"), "--output", out])
        wall = time.perf_counter() - t0
    finally:
        ic_lora.preprocess_canny = real
        if hidden is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = hidden
    counts = {**_counts(), "by_length": _flash_by_length()}
    st = stats[0]
    signal, canny_s = signals[0]
    with open(control + ".control.avi", "rb") as fh:
        control_sha = hashlib.sha256(fh.read()).hexdigest()
    full = {"fwd": counts["fwd"], "conv_fp32": st["control_encode_conv_launches"] + st["upscale_conv_launches"],
            "conv_bf16": st["decode_conv_launches"], "by_length": counts["by_length"]}
    rec = {"wall_s": wall, "canny_s": canny_s, "signal": list(signal.shape), "opencv_on_this_machine": opencv,
           "signal_equals_opencv": _sha256(signal[:9]) == meta["canny"][f"{low}_{high}"]["sha256_uint8"]
           and bool((signal[9:] == signal[8]).all()),
           "edge_pixels": int((signal[:9, ..., 0] > 0).sum()),
           "control_avi_equals_jax": control_sha == meta["control_avi_20_60_sha256"],
           "seconds": {p: st[f"{p}_s"] for p in ("control_encode", "stage1", "upscale", "stage2", "decode")},
           "frames": list(videos[0].shape), "launches": full, "raw_launches": raw_counts, "card": smi}
    del videos
    rec["opencv_route"] = _canny_opencv_route(control) if opencv else {"run": False, "why": "no OpenCV here"}
    log(f"ic-lora with Canny control ({WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, --save-control): "
        f"{json.dumps(rec)}")
    if not (rec["signal_equals_opencv"] and rec["control_avi_equals_jax"]) or rec["signal"] != [FRAMES, 256, 384, 3]:
        raise AssertionError(f"ic-lora canny: the signal or its .control.avi differ from the recorded hashes: {rec}")
    if opencv and not all(rec["opencv_route"]["equal"].values()):
        raise AssertionError(f"ic-lora canny: the port's Canny on OpenCV's frames differs from OpenCV's: "
                             f"{rec['opencv_route']}")
    if full != raw_counts or rec["frames"] != [FRAMES, HEIGHT, WIDTH, 3] or counts["bwd"] or \
            not all(st[f"{p}_latent_finite"] for p in ("stage1", "upscale", "stage2")):
        raise AssertionError(f"ic-lora canny: {rec}, expected the RAW run's launches {raw_counts}")
    return rec, full


def _canny_opencv_route(video: str) -> dict:
    """The route `--control-type canny` takes where OpenCV is installed:
    `preprocess_canny` with cv2 visible (frames through `cv2.VideoCapture`)
    at stage 1's 256x384 over all the video's frames, bit for bit against
    the JAX package's cv2 calls on the same `VideoCapture` frames
    (ltx2_tpu/pipelines/ic_lora.py: resize INTER_LANCZOS4, cvtColor
    BGR2GRAY, Canny, GRAY2RGB) at both threshold pairs; and each op of
    utils/canny.py against its cv2 call on its own (the resize also at
    512x768). Records the pixels that differ, and the seconds."""
    import cv2
    import numpy as np

    from ltx2_tpu_torch.pipelines import ic_lora
    from ltx2_tpu_torch.utils.canny import bgr_to_gray, canny, resize_lanczos4

    cap = cv2.VideoCapture(video)
    frames = []
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(frame)
    finally:
        cap.release()
    differ = {}

    def held(name, mine, theirs):
        differ[name] = differ.get(name, 0) + int((np.asarray(mine) != np.asarray(theirs)).sum())

    for w, h in ((384, 256), (WIDTH, HEIGHT)):
        for f in frames:
            held(f"resize_lanczos4_{h}x{w}", resize_lanczos4(f, w, h),
                 cv2.resize(f, (w, h), interpolation=cv2.INTER_LANCZOS4))
    grays = [cv2.cvtColor(cv2.resize(f, (384, 256), interpolation=cv2.INTER_LANCZOS4), cv2.COLOR_BGR2GRAY)
             for f in frames]
    for f, g in zip(frames, grays):
        held("bgr_to_gray", bgr_to_gray(cv2.resize(f, (384, 256), interpolation=cv2.INTER_LANCZOS4)), g)
    seconds, edges = {}, {}
    for low, high in CANNY_THRESHOLDS:
        for g in grays:
            held(f"canny_{low}_{high}", canny(g, low, high), cv2.Canny(g, low, high))
        want = np.stack([cv2.cvtColor(cv2.Canny(g, low, high), cv2.COLOR_GRAY2RGB) for g in grays])
        t0 = time.perf_counter()
        signal = ic_lora.preprocess_canny(video, 256, 384, len(frames), low, high)
        seconds[f"preprocess_canny_{low}_{high}"] = time.perf_counter() - t0
        held(f"preprocess_canny_{low}_{high}", signal, want)
        edges[f"{low}_{high}"] = int((want[..., 0] > 0).sum())
    return {"run": True, "opencv": cv2.__version__, "frames": len(frames), "shape": list(frames[0].shape),
            "equal": {k: v == 0 for k, v in differ.items()}, "pixels_differing": differ, "edge_pixels": edges,
            "seconds": seconds}


def phase_av_mjpeg(smi: str, directory: str) -> tuple:
    """The 2-block AV distilled flow (`generate.main --pipeline distilled
    --audio --layers 2`, 256x384x25) to an .avi and to a .mov: the PCM track
    read back by the port's readers bit for bit the int16 samples of the
    waveform the flow returned, the video track's frames read back."""
    import os

    import numpy as np
    import torch

    from ltx2_tpu_torch import generate as G
    from ltx2_tpu_torch.utils import video_io as vio

    c = AV_MJPEG
    rec, counts = {}, {"fwd": 0, "bwd": 0, "conv_fp32": 0, "conv_bf16": 0}
    for suffix, reader in (("avi", vio.read_avi_audio), ("mov", vio.read_mov_audio)):
        out = os.path.join(directory, f"av.{suffix}")
        torch.cuda.empty_cache()
        _reset_counts()
        t0 = time.perf_counter()
        results, stats = G.main(["--pipeline", "distilled", "--audio", "--layers", str(c["layers"]), "--height",
                                 str(c["height"]), "--width", str(c["width"]), "--frames", str(c["frames"]),
                                 "--output", out])
        wall = time.perf_counter() - t0
        run = _counts()
        st = stats[0]
        frames, wave = results[0]
        samples, rate = reader(out)
        written = vio._pcm_int16(wave)
        video = vio.read_video_any(out, c["height"], c["width"], c["frames"])
        rec[suffix] = {"wall_s": wall, "save_s": st["save_s"], "rate": rate, "samples": list(samples.shape),
                       "pcm_equal": bool(np.array_equal(np.round(samples * 32767.0).astype(np.int16), written.T)),
                       "video": list(video.shape), "bytes": os.path.getsize(out)}
        counts["fwd"] += run["fwd"]
        counts["bwd"] += run["bwd"]
        counts["conv_fp32"] += st.get("upscale_conv_launches", 0)
        counts["conv_bf16"] += st.get("decode_conv_launches", 0)
        if rate != st["audio_sample_rate"] or not rec[suffix]["pcm_equal"] or \
                rec[suffix]["video"] != [1, 3, c["frames"], c["height"], c["width"]]:
            raise AssertionError(f"AV flow to .{suffix}: {rec[suffix]}")
    rec.update(launches=counts, card=smi)
    log(f"AV flow at {c['layers']} blocks to MJPEG .avi / .mov ({c['width']}x{c['height']}x{c['frames']}f): "
        f"{json.dumps(rec)}")
    if counts["bwd"] or not counts["fwd"]:
        raise AssertionError(f"AV flow to MJPEG files: launches {counts}")
    return rec, counts


def phase_retake(smi: str, source: str, directory: str) -> tuple:
    """`python -m ltx2_tpu_torch.generate --pipeline retake` at full width
    and depth (the random 48-block bf16 DiT, the fp32 encoder, the bf16
    decoder) on the 512x768x121 y4m source, the window 1.0-3.0 s (latent
    frames 2-8 of 16), CFG 3.0 over 4 steps (cut from 30), to a .y4m: the
    read, encode (the encoder's time and peak on a 121-frame clip), denoise
    and decode seconds and peaks, flash launches by batch and length, the
    fp32 and bf16 conv launches; every latent token outside the window bit
    for bit the encoder's (`frozen_exact`, taken at the loop's end)."""
    import os

    import torch

    from ltx2_tpu_torch import generate
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.utils.video_io import y4m_header

    out = os.path.join(directory, "retake.y4m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _reset_flash_by()
    flash_attention.launches_by_length = {}
    t0 = time.perf_counter()
    videos, stats = generate.main([
        "--pipeline", "retake", "--video", source, "--retake-start", str(RETAKE["start"]),
        "--retake-end", str(RETAKE["end"]), "--num-inference-steps", str(RETAKE["steps"]),
        "--cfg-scale", str(RETAKE["cfg_scale"]), "--output", out])
    wall = time.perf_counter() - t0
    counts = {**_counts(), "by_batch": _flash_by("launches_by_batch"), "by_length": _flash_by_length()}
    st = stats[0]
    phases = ("encode", "denoise", "decode")
    rec = {"wall_s": wall, "read_s": st["read_s"], "dit_init_s": st["dit_init_s"],
           "seconds": {p: st[f"{p}_s"] for p in phases}, "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
           "denoise_step_s": st["denoise_step_s"], "encode_conv_launches": st["encode_conv_launches"],
           "decode_conv_launches": st["decode_conv_launches"], "decode_tiles": st["decode_tiles"],
           "frozen_exact": st["frozen_exact"], "retake_latent_frames": st["retake_latent_frames"],
           "frames": list(videos[0].shape), "y4m_bytes": os.path.getsize(out), "launches": counts, **RETAKE,
           "card": smi}
    del videos
    log(f"retake ({WIDTH}x{HEIGHT}x{FRAMES}f source, {LAYERS} layers, window {RETAKE['start']}-{RETAKE['end']} s, "
        f"CFG {RETAKE['cfg_scale']} over {RETAKE['steps']} steps): {json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    enc, dec = encoder_convs(VideoEncoderConfig()), decoder_convs(VideoDecoderConfig()) * tiles
    tokens = ((FRAMES - 1) // 8 + 1) * (HEIGHT // 32) * (WIDTH // 32)
    want_length = {f"{tokens}x{tokens}": LAYERS * RETAKE["steps"], f"{tokens}x1024": LAYERS * RETAKE["steps"]}
    header = len(y4m_header(WIDTH, HEIGHT, 24.0)) + FRAMES * (6 + 3 * HEIGHT * WIDTH)
    if (not rec["frozen_exact"] or rec["retake_latent_frames"] != [2, 9] or rec["frames"] != [FRAMES, HEIGHT, WIDTH, 3]
            or counts["by_batch"] != {2: 2 * LAYERS * RETAKE["steps"]} or counts["by_length"] != want_length
            or rec["encode_conv_launches"] != enc or rec["decode_conv_launches"] != dec
            or counts["conv"] != enc + dec or counts["bwd"] or rec["y4m_bytes"] != header
            or not st["denoise_latent_finite"]):
        raise AssertionError(f"retake: {rec}, expected the frozen tokens exact, latent frames [2, 9), flash by "
                             f"length {want_length} at batch 2, {enc} encoder and {dec} decoder convs, "
                             f"{header} y4m bytes")
    return rec, {"fwd": counts["fwd"], "fwd_by_batch": counts["by_batch"], "conv_fp32": enc, "conv_bf16": dec}


def _is_ic_lora_target(name: str) -> bool:
    return any(f".{part}." in name for part in ("attn1", "attn2", "ff"))


def phase_ic_lora(smi: str, directory: str) -> tuple:
    """`python -m ltx2_tpu_torch.generate --pipeline ic-lora` at full width
    and depth, 512x768x121: the committed MJPEG AVI as the RAW control
    (read at 256x384, its 9 frames padded to 121 with the last), a random
    rank-64 IC-LoRA on the attention and feed-forward linears of all 48
    blocks written to a file, fused for stage 1 (8 steps over 1536 + 1536
    appended tokens) and unfused after it, the fp32 upscaler, stage 2 at
    6144 tokens on the base weights, the tiled decode: each phase's seconds
    and peaks, flash launches by length, conv launches; after the unfuse
    every fused weight within one bf16 rounding step of its original (drawn
    again from make_dit's generator; every other weight equal to its draw).
    Then at 2 blocks, 256x384x25, the pipeline with the control at strength
    1.0: stage 1's appended control tokens bit for bit their clean latent at
    the loop's end."""
    import os

    import torch

    from ltx2_tpu_torch import generate as G
    from ltx2_tpu_torch.loader.lora import LoRAConfig
    from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics, VideoDecoderConfig
    from ltx2_tpu_torch.models.video_vae.decoder import conv_launches as decoder_convs
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig, video_encoder_apply
    from ltx2_tpu_torch.models.video_vae.encoder import conv_launches as encoder_convs
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs
    from ltx2_tpu_torch.ops.attention import flash_attention
    from ltx2_tpu_torch.pipelines import ic_lora
    from ltx2_tpu_torch.pipelines import retake as retake_module

    control, _ = _fixture(FIXTURE_AVI)
    lora_path = os.path.join(directory, "ic_lora.safetensors")
    t0 = time.perf_counter()
    lora_info = _write_distilled_lora(lora_path, LTXModel(LTXModelConfig(), device="meta"), rank=IC_LORA_RANK,
                                      keep=_is_ic_lora_target)
    lora_info.update(write_s=time.perf_counter() - t0, file_gb=os.path.getsize(lora_path) / 1e9)
    out = os.path.join(directory, "ic_lora.y4m")
    drift, host = {}, {"unfuse_call_s": [], "control_read_s": []}
    unfuse, read = ic_lora.unfuse_lora_deltas, retake_module.load_video_frames

    def read_timed(*args, **kwargs):  # the control's host read, inside the control-encode phase
        t1 = time.perf_counter()
        frames = read(*args, **kwargs)
        host["control_read_s"].append(time.perf_counter() - t1)
        return frames

    def unfuse_checked(model, applied):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = unfuse(model, applied)
        torch.cuda.synchronize()
        host["unfuse_call_s"].append(time.perf_counter() - t1)
        if not drift:  # inside the lora_unfuse phase's seconds
            t1 = time.perf_counter()
            drift.update(_lora_drift(model, applied))
            drift["check_s"] = time.perf_counter() - t1
        return result

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _reset_flash_by()
    flash_attention.launches_by_length = {}
    ic_lora.unfuse_lora_deltas, retake_module.load_video_frames = unfuse_checked, read_timed
    try:
        t0 = time.perf_counter()
        videos, stats = G.main(["--pipeline", "ic-lora", "--control-video", control, "--control-type", "raw",
                                "--ic-lora-weights", lora_path, "--output", out])
        wall = time.perf_counter() - t0
    finally:
        ic_lora.unfuse_lora_deltas, retake_module.load_video_frames = unfuse, read
    counts = {**_counts(), "by_batch": _flash_by("launches_by_batch"), "by_length": _flash_by_length()}
    st = stats[0]
    phases = ("lora_fuse", "control_encode", "stage1", "lora_unfuse", "upscale", "stage2", "decode")
    rec = {"wall_s": wall, "dit_init_s": st["dit_init_s"], "lora": lora_info, "lora_drift": drift, **host,
           "seconds": {p: st[f"{p}_s"] for p in phases}, "peak_gb": {p: st[f"{p}_peak_gb"] for p in phases},
           "conv_launches": {p: st[f"{p}_conv_launches"] for p in ("control_encode", "upscale")},
           "decode_conv_launches": st["decode_conv_launches"], "frames": list(videos[0].shape),
           "y4m_bytes": os.path.getsize(out), "launches": counts, "card": smi}
    del videos
    log(f"ic-lora ({WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, the fixture as RAW control, rank-{IC_LORA_RANK} "
        f"IC-LoRA on {lora_info['targets']} linears): {json.dumps(rec)}")
    tiles = len(generate_tile_specs((1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32),
                                    TilingConfig.default()))
    enc, ups = encoder_convs(VideoEncoderConfig()), upscaler_convs(SpatialUpscalerConfig())
    dec = decoder_convs(VideoDecoderConfig()) * tiles
    s1 = ((FRAMES - 1) // 8 + 1) * (HEIGHT // 64) * (WIDTH // 64)
    s2 = 4 * s1
    want_length = {f"{2 * s1}x{2 * s1}": LAYERS * 8, f"{2 * s1}x1024": LAYERS * 8, f"{s2}x{s2}": LAYERS * 3,
                   f"{s2}x1024": LAYERS * 3}
    targets = sum(1 for n, p in LTXModel(LTXModelConfig(), device="meta").named_parameters()
                  if n.startswith("transformer_blocks.") and n.endswith(".weight") and p.ndim == 2
                  and _is_ic_lora_target(n))
    if (rec["frames"] != [FRAMES, HEIGHT, WIDTH, 3] or counts["by_length"] != want_length
            or counts["by_batch"] != {1: 2 * LAYERS * 11} or rec["conv_launches"] != {"control_encode": enc,
                                                                                   "upscale": ups}
            or rec["decode_conv_launches"] != dec or counts["conv"] != enc + ups + dec or counts["bwd"]
            or not all(st[f"{p}_latent_finite"] for p in ("stage1", "upscale", "stage2"))):
        raise AssertionError(f"ic-lora: {rec}, expected flash by length {want_length}, convs {enc} + {ups} + {dec}")
    if not drift or drift["tensors"] != lora_info["targets"] or lora_info["targets"] != targets:
        raise AssertionError(f"ic-lora: the drift check saw {drift}, not the {targets} fused weights")
    if not drift["untouched_equal"] or drift["max_steps"] > TOL_LORA_DRIFT_STEPS:
        raise AssertionError(f"ic-lora: the unfused weights drifted, or an untouched one moved: {drift}")
    full = {"fwd": counts["fwd"], "conv_fp32": enc + ups, "conv_bf16": dec, "by_length": counts["by_length"]}

    # The small run: strength 1.0 keeps the appended control tokens clean.
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    _reset_counts()
    c = IC_SMALL
    dit, encoder, upscaler = G.make_dit(c["layers"], dev), G.make_encoder(dev), G.make_upscaler(dev)
    pipe = ic_lora.ICLoraPipeline(dit, upscaler, statistics=PerChannelStatistics(128, device=dev),
                                  video_encoder=encoder)
    ends = []
    stage1_loop = pipe.loops[(False, False)]  # per-token timesteps: stage 1 with the control

    def recorded(*args, **kwargs):
        state = stage1_loop(*args, **kwargs)
        ends.append(state)
        return state

    pipe.loops[(False, False)] = recorded
    config = ic_lora.ICLoraConfig(height=c["height"], width=c["width"], num_frames=c["frames"], seed=3,
                                  dtype="bfloat16", ic_lora_config=LoRAConfig(lora_path))
    context = G.dummy_context(dit.cfg, torch.Generator(device=dev).manual_seed(3), dev)
    latent = pipe(context, config, videos=[ic_lora.VideoCondition(control, strength=1.0)], skip_decode=True)
    small_counts = _counts()  # the run's launches, before the check below encodes the control again
    video = torch.from_numpy(retake_module.load_video_frames(control, c["height"] // 2, c["width"] // 2,
                                                             c["frames"])).to(dev)
    with torch.no_grad():
        clean = pipe.patchifier.patchify(video_encoder_apply(encoder, video.to(torch.bfloat16))).to(torch.bfloat16)
    state = ends[0]
    n = state.latent.shape[1] - clean.shape[1]
    small = {"layers": c["layers"], "shape": [c["frames"], c["height"], c["width"]], "stage1_tokens": n,
             "control_tokens": clean.shape[1], "latent": list(latent.shape),
             "control_exact": bool(torch.equal(state.latent[:, n:], state.clean_latent[:, n:])),
             "control_is_the_encoders": bool(torch.equal(state.clean_latent[:, n:], clean)),
             "video_moved": not bool(torch.equal(state.latent[:, :n], state.clean_latent[:, :n])),
             "launches": small_counts}
    rec["small_strength_1"] = small
    log(f"ic-lora at {c['layers']} blocks, control strength 1.0: {json.dumps(small)}")
    del pipe, dit, encoder, upscaler, ends, state
    torch.cuda.empty_cache()
    if not (small["control_exact"] and small["control_is_the_encoders"] and small["video_moved"]):
        raise AssertionError(f"ic-lora: the strength-1.0 control tokens moved, or are not the encoder's: {small}")
    if small_counts != {"fwd": 2 * c["layers"] * 11, "bwd": 0, "conv": enc + ups}:
        raise AssertionError(f"ic-lora at {c['layers']} blocks: launches {small_counts}")
    return rec, full, small["launches"]


def phase_prepare_videos(smi: str, directory: str) -> tuple:
    """`prepare_data --videos` on a directory of the committed MJPEG AVI and
    a 17-frame 288x432 .y4m (--num-frames 12, snapped to 9) through the
    full-width fp32 encoder at 512x768, then `--images` on the committed
    512x768 JPEG still; the npz fed to one `train.main --data` LoRA step at
    cut depth."""
    import os
    import shutil

    import numpy as np
    import torch

    from ltx2_tpu_torch import prepare_data as P
    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig, conv_launches

    videos, images = os.path.join(directory, "videos"), os.path.join(directory, "images")
    os.makedirs(videos)
    os.makedirs(images)
    avi, _ = _fixture(FIXTURE_AVI)
    jpg, _ = _fixture(FIXTURE_JPG)
    shutil.copy(avi, videos)
    shutil.copy(jpg, images)
    _write_source_y4m(os.path.join(videos, "short.y4m"), 17, 288, 432, seed=13)
    torch.cuda.empty_cache()
    _reset_train_counts()
    out = os.path.join(directory, "video_latents.npz")
    t0 = time.perf_counter()
    res = P.main(["--videos", videos, "--num-frames", "12", "--placeholder", "--context-dim", "4096",
                  "--output", out, "--device", "cuda"])
    wall = time.perf_counter() - t0
    still = P.main(["--images", images, "--placeholder", "--context-dim", "4096", "--device", "cuda",
                    "--output", os.path.join(directory, "still_latents.npz")])
    counts = _train_counts()  # both runs' launches
    tokens = 2 * (HEIGHT // 32) * (WIDTH // 32)
    rec = {"clips": 2, "encode_s": res["encode_s"], "wall_s": wall, "x0": list(res["x0"].shape),
           "positions": list(res["positions"].shape), "finite": bool(np.isfinite(res["x0"]).all()),
           "still_x0": list(still["x0"].shape), "still_finite": bool(np.isfinite(still["x0"]).all()),
           "launches": counts, "expected_conv": 3 * conv_launches(VideoEncoderConfig()), "card": smi}
    torch.cuda.empty_cache()
    step = T.main(["--data", out, "--lora-rank", "16", "--steps", "1", "--layers", str(CUT_LAYERS), "--device", "cuda"])
    rec["train_loss"] = step["losses"][0]
    log(f"prepare_data --videos / --images .jpg: {json.dumps(rec)}")
    del step
    torch.cuda.empty_cache()
    if counts["conv"] != rec["expected_conv"] or counts["fwd"] or counts["bwd"]:
        raise AssertionError(f"prepare_data --videos launches {counts}, expected {rec['expected_conv']} fp32 convs")
    if (rec["x0"] != [2, tokens, 128] or rec["positions"] != [2, 3, tokens, 2] or not rec["finite"]
            or rec["still_x0"] != [1, tokens // 2, 128] or not rec["still_finite"]):
        raise AssertionError(f"prepare_data --videos arrays {rec}")
    if not math.isfinite(rec["train_loss"]):
        raise AssertionError(f"a train step on prepare_data --videos' npz: loss {rec['train_loss']}")
    return rec, counts


# The full video VAE (the non-"simple" path) at full width on a 17 x 256 x
# 384 clip, random weights from the port's init (scale/shift tables and
# statistics drawn non-zero).
FULL_VAE = {"frames": 17, "height": 256, "width": 384}
# The strided encoder vocabulary: each residual compress_*_res block of the
# default encoder replaced by its strided compress_* conv and a res_x_y.
FULL_VAE_STRIDED_CONVS = 4


def _strided_vocabulary(blocks) -> tuple:
    out = []
    for name, cfg in blocks:
        if name.endswith("_res"):
            out += [(name[:-len("_res")], {}), ("res_x_y", {"multiplier": cfg.get("multiplier", 2)})]
        else:
            out.append((name, cfg))
    return tuple(out)


def phase_full_vae(smi: str) -> tuple:
    """The full VAE's paths at full width, each through the kernels and again
    with every conv on its plain version on the card, held to the small
    check's limits (latents and activations: relative rms 1e-2, which the
    kernel output x 1.03 must fail; decoded frames: 2 levels on average,
    which another latent's frames must fail): the default encoder in fp32;
    the strided-vocabulary encoder with
    group norm in fp32 (its 4 strided convs on the kernel); a dims=(2, 1)
    UNetMidBlock3D (2 ResnetBlock3Ds of DualConv3d, group norm, non-causal
    zero padding, the only semantics the dual conv has) on the strided
    encoder's 512-wide stage; the default decoder in bf16 with timestep
    conditioning (per-block embeddings, the last scale/shift) and decode
    noise from a generator. Each path's first call: seconds, peak GB above
    what was allocated before, conv and strided launches (counts reset just
    before, read just after). Returns (the record, each path's launches)."""
    import torch

    from ltx2_tpu_torch.models.video_vae import full_vae as fv
    from ltx2_tpu_torch.models.video_vae import resnet

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    f, h, w = FULL_VAE["frames"], FULL_VAE["height"], FULL_VAE["width"]
    video = torch.rand(1, 3, f, h, w, generator=gen, device=dev) * 2 - 1

    def randomize(module):
        with torch.no_grad():
            for name, p in module.named_parameters():
                if "scale_shift_table" in name:
                    p.normal_(generator=gen).mul_(0.2)
            for name, b in module.named_buffers():
                if name.endswith("mean_of_means"):
                    b.normal_(generator=gen).mul_(0.3)
                elif name.endswith("std_of_means"):
                    b.uniform_(0.5, 1.5, generator=gen)
        return module

    def frames_u8(video):
        """(1, 3, F, H, W) in [-1, 1] -> uint8 (F, H, W, 3)."""
        return ((video[0].float().clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).permute(1, 2, 3, 0).cpu().numpy()

    def run(name, call, want_conv, want_strided, other=None):
        """`other`: for a decoder, the plain run on another latent, which the
        frames' limit must reject."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = call(None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"conv": _counts()["conv"], "strided": _counters()["conv"].strided_launches,
                  "fwd": _counts()["fwd"]}
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        with _plain_kernels():
            ref = call(None)
            ref_other = other() if other is not None else None
        m = _mismatch(out.float(), ref.float())
        rec = {"shape": list(out.shape), "seconds_first_call": seconds, "peak_gb": peak, "launches": counts,
               "vs_plain": {k: v for k, v in m.items() if k != "ref_rms"}}
        if other is None:
            # Latents and activations: the small check's relative rms.
            planted = _mismatch(out.float() * 1.03, ref.float())
            rec.update({"planted_scaled_1.03_rms_rel": planted["rms_rel_err"], "tol_rms_rel": TOL_SMALL_LATENT_RMS_REL})
            ok, caught = m["rms_rel_err"] <= TOL_SMALL_LATENT_RMS_REL, planted["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL
        else:
            # Decoded frames: the small check's mean levels, another latent's frames planted.
            rec.update({"frames_vs_plain": _frame_diff(frames_u8(out), frames_u8(ref)),
                        "planted_other_latent": _frame_diff(frames_u8(ref_other), frames_u8(ref)),
                        "tol_mean_levels": TOL_SMALL_MEAN_LEVELS})
            ok = rec["frames_vs_plain"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS
            caught = rec["planted_other_latent"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS
        log(f"full VAE {name}: {json.dumps(rec)} | {smi}")
        if not m["finite"] or not ok:
            raise AssertionError(f"full VAE {name}: kernels disagree with the plain path: {rec}")
        if not caught:
            raise AssertionError(f"full VAE {name}: the check accepts a planted fault: {rec}")
        if counts != {"conv": want_conv, "strided": want_strided, "fwd": 0}:
            raise AssertionError(f"full VAE {name}: launches {counts}, expected {want_conv} ({want_strided} strided)")
        return rec, counts

    recs, counts = {}, {}
    t_start = time.perf_counter()
    enc_cfg = fv.FullVideoEncoderConfig()
    enc = randomize(fv.init_full_video_encoder_(fv.FullVideoEncoder(enc_cfg, device=dev), gen))
    n = fv.conv_launches(enc_cfg)
    recs["encoder"], counts["encoder"] = run("encoder (default, fp32)",
                                             lambda _: fv.full_video_encoder_apply(enc, video), n["all"], 0)
    del enc
    torch.cuda.empty_cache()
    strided_cfg = fv.FullVideoEncoderConfig(blocks=_strided_vocabulary(fv.DEFAULT_ENCODER_BLOCKS),
                                            norm_layer=resnet.NormLayerType.GROUP_NORM)
    enc = randomize(fv.init_full_video_encoder_(fv.FullVideoEncoder(strided_cfg, device=dev), gen))
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if ".norm" in name or "conv_norm_out" in name:
                p.add_(torch.randn(p.shape, generator=gen, device=dev) * 0.2)
    n = fv.conv_launches(strided_cfg)
    if n["strided"] != FULL_VAE_STRIDED_CONVS:
        raise AssertionError(f"the strided vocabulary has {n['strided']} strided convs")
    recs["encoder_strided"], counts["encoder_strided"] = run(
        "encoder (strided vocabulary, group norm, fp32)", lambda _: fv.full_video_encoder_apply(enc, video),
        n["all"], n["strided"])
    recs["encoder_strided"]["blocks"] = [b[0] for b in strided_cfg.blocks]
    del enc
    torch.cuda.empty_cache()
    mid_cfg = resnet.UNetMidBlock3DConfig(dims=(2, 1), in_channels=512, num_layers=2, inject_noise=True)
    mid = randomize(resnet.init_blocks_(resnet.UNetMidBlock3D(mid_cfg, device=dev), gen))
    with torch.no_grad():
        for name, p in mid.named_parameters():
            if "per_channel_scale" in name:
                p.uniform_(0.05, 0.2, generator=gen)
    x_mid = torch.randn(1, (f - 1) // 2 + 1, h // 8, w // 8, 512, generator=gen, device=dev)

    def mid_call(_):
        noise = [tuple(torch.randn(*x_mid.shape[:4], 1, generator=torch.Generator(device=dev).manual_seed(43 + i),
                                   device=dev) for _ in range(2)) for i in range(2)]
        return resnet.unet_mid_block_3d_apply(mid, x_mid, causal=False, noise=noise)

    recs["mid_block_dual"], counts["mid_block_dual"] = run("UNetMidBlock3D dims=(2, 1) (fp32)", mid_call,
                                                           resnet.conv_launches(mid), 0)
    del mid, x_mid
    torch.cuda.empty_cache()
    dec_cfg = fv.FullVideoDecoderConfig(timestep_conditioning=True, compute_dtype="bfloat16")
    dec = randomize(fv.init_full_video_decoder_(fv.FullVideoDecoder(dec_cfg, device=dev), gen))
    latent = torch.randn(1, 128, (f - 1) // 8 + 1, h // 32, w // 32, generator=gen, device=dev)
    embeddings = [torch.randn(1, 4 * c_in, generator=gen, device=dev) * 0.1 if name == "res_x" else None
                  for name, _cfg, c_in, _c_out in dec_cfg.plan]
    last = torch.randn(1, 2 * dec_cfg.final_channels, generator=gen, device=dev) * 0.1

    def dec_call(_, z=latent):
        return fv.full_video_decoder_apply(dec, z, embeddings, last,
                                           generator=torch.Generator(device=dev).manual_seed(44))

    other_latent = torch.randn(latent.shape, generator=gen, device=dev)
    recs["decoder"], counts["decoder"] = run("decoder (default, bf16, timestep-conditioned, decode noise)", dec_call,
                                             fv.conv_launches(dec_cfg)["all"], 0, other=lambda: dec_call(None, other_latent))
    noise_moves = _mismatch(dec_call(None).float(), fv.full_video_decoder_apply(dec, latent, embeddings, last).float())
    recs["decoder"]["decode_noise_rms_rel"] = noise_moves["rms_rel_err"]
    del dec
    torch.cuda.empty_cache()
    if recs["decoder"]["shape"] != [1, 3, f, h, w] or recs["encoder"]["shape"] != [1, 128, 3, h // 32, w // 32]:
        raise AssertionError(f"full VAE shapes {recs['encoder']['shape']}, {recs['decoder']['shape']}")
    if recs["encoder_strided"]["shape"] != recs["encoder"]["shape"] or noise_moves["rms_rel_err"] == 0:
        raise AssertionError(f"full VAE: strided encoder {recs['encoder_strided']['shape']}, decode noise {noise_moves}")
    recs["wall_s"] = time.perf_counter() - t_start
    log(f"full VAE: {recs['wall_s']:.1f} s for the four paths and their plain runs | {smi}")
    return recs, counts


WEBP_ANIMATIONS = ("webp_lossy_alpha_96x144x9.webp", "webp_lossless_96x144x9.webp")


def phase_webp(smi: str) -> dict:
    """The committed WebP fixtures (tests/fixtures_video: a lossy still at
    256x384, a lossless still with alpha, a lossy animation with alpha, a
    lossless animation) decoded by the port's reader on the card's host,
    held to the SHA-256 of PIL's frames that media_io.json records, probed
    as the JAX package probes them, with host ms a frame of each (the best
    of 3)."""
    import os

    import numpy as np

    from ltx2_tpu_torch.utils import video_io as vio
    from ltx2_tpu_torch.utils.webp import read_webp_frames

    t_start = time.perf_counter()
    directory = os.path.dirname(_fixture(FIXTURE_AVI)[0])
    meta = json.loads(open(os.path.join(directory, MEDIA_JSON), encoding="utf-8").read())["webp"]
    checks, ms, sizes = {}, {}, {}
    for name, want in sorted(meta.items()):
        path = os.path.join(directory, name)
        with open(path, "rb") as fh:
            data = fh.read()
        frames = np.stack(read_webp_frames(data))
        checks[name] = _sha256(frames) == want["sha256_pil_frames_uint8"]
        checks[f"{name}_probe"] = list(vio.probe_video(path)) == [24.0, want["frames"], want["height"], want["width"]]
        ms[name] = _host_ms(lambda: read_webp_frames(data)) / len(frames)
        sizes[name] = len(data)
    largest = max(meta, key=lambda k: meta[k]["height"] * meta[k]["width"])
    rec = {"checks": checks, "host_ms_per_frame": ms, "bytes": sizes, "largest": largest,
           "largest_host_ms_per_frame": ms[largest], "phase_s": time.perf_counter() - t_start, "card": smi}
    log(f"WebP reader (host): {json.dumps(rec)}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"WebP reader: {bad} differ from tests/fixtures_video/{MEDIA_JSON}")
    return rec


def phase_video_paths(smi: str) -> tuple:
    """The readers, retake, ic-lora and prepare_data --videos in one
    temporary directory (the 512x768x121 source is written once). Returns
    (the record, the launches of each path)."""
    import os
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="ltx2_video_paths_")
    t_start = time.perf_counter()
    try:
        source = os.path.join(directory, "source.y4m")
        t0 = time.perf_counter()
        _write_source_y4m(source, FRAMES, HEIGHT, WIDTH)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        media = phase_media_io(smi, directory)
        media["phase_s"] = time.perf_counter() - t0
        readers = phase_readers(smi, source)
        retake, retake_counts = phase_retake(smi, source, directory)
        ic, ic_counts, ic_small_counts = phase_ic_lora(smi, directory)
        t0 = time.perf_counter()
        ic_canny, ic_canny_counts = phase_ic_lora_canny(smi, directory, ic_counts)
        ic_canny["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        av_mjpeg, av_mjpeg_counts = phase_av_mjpeg(smi, directory)
        av_mjpeg["phase_s"] = time.perf_counter() - t0
        prep, prep_counts = phase_prepare_videos(smi, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    rec = {"source_write_s": write_s, "media_io": media, "readers": readers, "retake": retake, "ic_lora": ic,
           "ic_lora_canny": ic_canny, "av_mjpeg": av_mjpeg, "prepare_data_videos": prep,
           "wall_s": time.perf_counter() - t_start, "card": smi}
    log(f"video paths: media I/O, the readers, retake, ic-lora (RAW and Canny), the AV flow to MJPEG files and "
        f"prepare_data --videos took {rec['wall_s']:.1f} s (media I/O {media['phase_s']:.1f}, Canny ic-lora "
        f"{ic_canny['phase_s']:.1f}, AV to MJPEG {av_mjpeg['phase_s']:.1f}) | {smi}")
    return rec, {"retake": retake_counts, "ic_lora": ic_counts, "ic_lora_small": ic_small_counts,
                 "ic_lora_canny": ic_canny_counts, "av_mjpeg": av_mjpeg_counts, "prepare_data_videos": prep_counts}


# ---------------------------------------------------------------- scale-out
# The serving half of scale-out (ltx2_tpu_torch/parallel/) on the card:
# SCALE_OUT_WORLD ranks in processes of their own (parallel.runtime.
# spawn_ranks), all on the one card over gloo (the ring's CUDA payloads
# staged through pinned host buffers), or over nccl with a card per rank
# where the machine has as many.
SCALE_OUT_WORLD = 2
SCALE_OUT_SEED = 5
# The phase's DiT depth, cut from 48 for the whole script's time (PR 24): the
# SP, TP and PP runs and their world-1 references all take this many blocks.
# Not fewer: a PP-2 rank holds half the blocks and all the shared weights,
# 0.564 of world 1's at 12 blocks, past TOL_PP_WEIGHT_SHARE.
SCALE_OUT_LAYERS = 24
SCALE_OUT_TIMEOUT_S = 900  # the ranks' join; a collective waits at most PG_TIMEOUT_S
SCALE_OUT_PG_TIMEOUT_S = 600
# Ring attention at 1x32x6144^2x128 against the single-card K1 output and
# the plain version: the ring merges bf16 block outputs in fp32, so the
# flash cases' limits (TOL_MAX_REL, TOL_RMS_REL) hold it.
RING_SHAPE = (1, 32, 6144, 128)
# The SP-2 distilled clip against world 1 on the same seed: both run every
# op in bf16 on the kernels; the ring changes the order of each
# self-attention's sums, which 11 DiT steps, the upscaler and the decoder
# carry (limits of the small two-stage check: latents rms 1 %, frames 2
# levels on average; the maximum is recorded).
TOL_SP_LATENT_RMS_REL = 1e-2
TOL_SP_MEAN_LEVELS = 2.0
# The TP-2 DiT step at 6144 tokens against world 1: each row-parallel
# product summed over the ranks in fp32, then rounded once.
TOL_TP_X0_RMS_REL = 1e-2
# The W-sharded decode against the unsharded one: the W-valid kernel sums
# each output in the order the padded kernel does; the tile-parallel
# decode blends the same tiles in the JAX package's order.
TOL_W_DECODE_MAX_ABS = 1e-2
TOL_TILES_DECODE_MAX_ABS = 1e-4
SO_DECODE_LATENT = (1, 128, 5, 16, 24)  # 33 x 512 x 768 pixels: the untiled W-sharded decode
SO_TILED_LATENT = (1, 128, 16, 16, 24)  # the 512x768x121 clip's latent: 6 tiles of the default tiling


def _so_counts() -> dict:
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel as K

    return {"fwd": A.flash_attention.launches, "residuals": A.flash_attention_residuals.launches,
            "conv": K.launches, "conv_w_valid": K.w_valid_launches}


def _so_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _so_counts().items()}


def _so_ring(rank: int, world: int, mesh) -> dict:
    """ring_sdpa at RING_SHAPE on every rank; rank 0 holds it to the
    single-card K1 output and the plain version."""
    import torch

    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.parallel.ring_attention import ring_sdpa

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SCALE_OUT_SEED)
    q, k, v = (torch.randn(RING_SHAPE, device=dev, generator=gen).to(torch.bfloat16) for _ in range(3))
    before = _so_counts()
    collectives.reset_stats()
    out = ring_sdpa(q, k, v, mesh)
    launches = _so_delta(before)
    bytes_one = dict(sent=collectives.STATS["bytes_sent"], received=collectives.STATS["bytes_received"],
                     routes=dict(collectives.STATS["routes"]))
    if launches["residuals"] != world:
        raise AssertionError(f"rank {rank}: K2 launched {launches['residuals']} times in one ring call, not {world}")
    ms = _time_ms(lambda: ring_sdpa(q, k, v, mesh), 3)
    rec = {"launches_per_call": launches, "bytes_per_call": bytes_one, "ms": ms}
    if rank == 0:
        ref = A.flash_attention(q, k, v)
        plain = torch.cat([A.flash_attention_plain(q[:, h:h + 8], k[:, h:h + 8], v[:, h:h + 8])
                           for h in range(0, RING_SHAPE[1], 8)], dim=1)
        rec["vs_k1"], rec["vs_plain"] = _mismatch(out, ref), _mismatch(out, plain)
        rec["k1_ms"] = _time_ms(lambda: A.flash_attention(q, k, v), 3)
        for what in ("vs_k1", "vs_plain"):
            if not _accepted(rec[what]):
                raise AssertionError(f"ring attention {what}: {rec[what]} outside {TOL_MAX_REL}, {TOL_RMS_REL}")
    return rec


def _so_clip(dit, mesh=None, skip_decode: bool = False):
    """The distilled clip at SCALE_OUT_SEED through the entry point, on the
    sequence mesh `mesh` (None: world 1): its frames, or with `skip_decode`
    its stage-2 latent, and its stats."""
    from ltx2_tpu_torch.generate import generate_videos_distilled

    out, stats = generate_videos_distilled([SCALE_OUT_SEED], height=HEIGHT, width=WIDTH, frames=FRAMES,
                                           layers=SCALE_OUT_LAYERS, device="cuda", dit=dit,
                                           skip_decode=skip_decode,
                                           meshes=None if mesh is None else {"sequence_mesh": mesh})
    return out[0], stats[0]


def _so_sp_clip(rank: int, mesh, dit) -> dict:
    """The SP distilled clip, decoded, with its launches, seconds, peak
    memory and exchanges; then its stage-2 latent (a second run, which
    skips the decode). Rank 0 keeps the frames and the latent."""
    import torch

    from ltx2_tpu_torch.parallel import collectives

    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    before = _so_counts()
    t0 = time.perf_counter()
    frames, stats = _so_clip(dit, mesh)
    rec = {"stats": stats, "seconds": time.perf_counter() - t0, "launches": _so_delta(before),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "bytes_sent": collectives.STATS["bytes_sent"],
           "bytes_received": collectives.STATS["bytes_received"], "calls": dict(collectives.STATS["calls"]),
           "routes": dict(collectives.STATS["routes"])}
    t0 = time.perf_counter()
    latent, _ = _so_clip(dit, mesh, skip_decode=True)
    rec["latent_run_s"] = time.perf_counter() - t0
    if rank == 0:
        rec["frames"], rec["latent"] = frames, latent
    return rec


def _so_tp_step(rank: int, mesh, dit) -> dict:
    """One x0 step at 6144 tokens: world 1 on rank 0 on the whole DiT, then
    the DiT made each rank's TP shard and the step again."""
    import torch

    from ltx2_tpu_torch.loader.fp8 import weight_bytes
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.parallel.sharding import shard_dit_params

    ref = _x0(dit, SCALE_OUT_SEED) if rank == 0 else None
    shard_dit_params(mesh, dit)
    torch.cuda.empty_cache()
    weights_gb = weight_bytes(dit) / 1e9
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    t0 = time.perf_counter()
    x0 = _x0(dit, SCALE_OUT_SEED)
    torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "resident_weights_gb": weights_gb, "bytes_sent": collectives.STATS["bytes_sent"],
           "bytes_received": collectives.STATS["bytes_received"]}
    if rank == 0:
        rec["vs_world_1"] = _mismatch(x0, ref)
        if not rec["vs_world_1"]["finite"] or rec["vs_world_1"]["rms_rel_err"] > TOL_TP_X0_RMS_REL:
            raise AssertionError(f"TP x0 against world 1: {rec['vs_world_1']} outside rms {TOL_TP_X0_RMS_REL}")
    return rec


def _so_decodes(rank: int, world: int) -> dict:
    """The W-sharded decode and the tile-parallel decode over every rank
    (the bf16 decoder, no decode noise); rank 0 holds each to the unsharded
    decode."""
    import torch

    from ltx2_tpu_torch.generate import make_decoder
    from ltx2_tpu_torch.models.video_vae.decoder import video_decoder_apply
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, decode_tiled, decode_w_sharded
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.parallel.mesh import create_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    decoder = make_decoder("bfloat16", dev)
    mesh = create_mesh(data=world, model=1)
    gen = torch.Generator(device=dev).manual_seed(SCALE_OUT_SEED + 1)
    latent = torch.randn(SO_DECODE_LATENT, device=dev, generator=gen)
    tiled = torch.randn(SO_TILED_LATENT, device=dev, generator=gen)

    def apply(z, timestep=0.05):
        return video_decoder_apply(decoder, z, timestep=timestep)

    rec = {}
    with torch.no_grad():
        for name, call in (("w_sharded", lambda: decode_w_sharded(latent, decoder, mesh)),
                           ("tile_parallel", lambda: decode_tiled(tiled, apply, TilingConfig.default(), mesh=mesh))):
            collectives.reset_stats()
            torch.cuda.reset_peak_memory_stats()
            before = _so_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            rec[name] = {"seconds": time.perf_counter() - t0, "launches": _so_delta(before),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "bytes_sent": collectives.STATS["bytes_sent"], "routes": dict(collectives.STATS["routes"])}
            if rank == 0:
                t0 = time.perf_counter()
                ref = apply(latent) if name == "w_sharded" else decode_tiled(tiled, apply, TilingConfig.default())
                torch.cuda.synchronize()
                rec[name]["unsharded_seconds"] = time.perf_counter() - t0
                diff = (out.float() - ref.float()).abs()
                rec[name].update(max_abs=float(diff.max()), rms=float(diff.square().mean().sqrt()),
                                 bitwise=bool(torch.equal(out, ref)))
                tol = TOL_W_DECODE_MAX_ABS if name == "w_sharded" else TOL_TILES_DECODE_MAX_ABS
                if not bool(torch.isfinite(out).all()) or rec[name]["max_abs"] > tol:
                    raise AssertionError(f"{name} decode against the unsharded one: {rec[name]} outside {tol}")
                del ref
            del out
            torch.cuda.empty_cache()
    if rec["w_sharded"]["launches"]["conv_w_valid"] == 0:
        raise AssertionError(f"rank {rank}: the W-sharded decode launched no W-valid conv")
    return rec


def _residuals_case(smi: str) -> dict:
    """K2 alone at the ring's block shape on 2 ranks (3072 queries x 3072
    keys of RING_SHAPE): its outputs, l and m against the plain version,
    its time by the profiler and by CUDA events, the plain version's and
    SDPA's (the library yardstick: the output alone), and its bound."""
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops import attention as A

    b, h, t, d = RING_SHAPE
    t //= SCALE_OUT_WORLD
    gen = torch.Generator(device="cuda").manual_seed(SCALE_OUT_SEED + 2)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    before = A.flash_attention.launches, A.flash_attention_residuals.launches
    o, l, m = A.flash_attention_residuals(q, k, v)
    o_ref, l_ref, m_ref = A.flash_attention_residuals_plain(q, k, v)
    err = {"o": _mismatch(o, o_ref), "l": _mismatch(l, l_ref), "m": _mismatch(m, m_ref)}
    if not _accepted(err["o"]) or any(err[x]["max_rel_err"] > TOL_RES_REL for x in ("l", "m")):
        raise AssertionError(f"K2 at the ring's block shape against its plain version: {err}")
    call = lambda: A.flash_attention_residuals(q, k, v)  # noqa: E731
    ms = _time_ms(call, 10)
    kernel_ms, timed_by, _, events_ms = _kernel_ms(call, "flash_fwd_kernel", 10)
    plain_ms = _time_ms(lambda: A.flash_attention_residuals_plain(q, k, v), 2)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    flops = 4.0 * b * h * t * t * d
    nbytes = 2.0 * 4 * b * h * t * d + 2 * 4.0 * b * h * t
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    A.flash_attention.launches, A.flash_attention_residuals.launches = before  # comparison launches
    rec = {"case": "ring_block", "shape": [b, h, t, t, d], "max_abs_err": err["o"]["max_abs_err"],
           "errors": {x: {y: e[y] for y in ("max_rel_err", "rms_rel_err")} for x, e in err.items()},
           "ms": ms, "kernel_ms": kernel_ms, "kernel_timed_by": timed_by, "kernel_events_ms": events_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"}
    log(f"K2 check ring_block: {json.dumps(rec)} | {smi}")
    del q, k, v, o, l, m, o_ref, l_ref, m_ref
    torch.cuda.empty_cache()
    return rec


# Pipeline parallelism, the six pipelines' meshes, --auto-shard and the
# server on several ranks, through the command line at full width and
# PP_CLI_LAYERS blocks: a 256x384x25 clip (384 tokens, 96 at stage 1, 26
# audio tokens: every count SP-2 divides; latent W 12, which --vae-w-shard 2
# splits). Each is held to world 1's run of the same arguments.
PP_CLI_LAYERS = 2
PP_CLI_SIZE = ("--height", "256", "--width", "384", "--frames", "25", "--seed", str(SCALE_OUT_SEED))
PP_CLI_FLOWS = {
    "one_stage_pp": (["--pipeline", "one-stage", "--num-inference-steps", "3"], ["--pp-stages", "2"]),
    "keyframe_sp": (["--pipeline", "keyframe"], ["--sp-devices", "2", "--vae-w-shard", "2"]),
    "a2vid_sp": (["--pipeline", "a2vid", "--audio"], ["--sp-devices", "2", "--vae-w-shard", "2"]),
    "auto_shard": (["--pipeline", "distilled"], ["--auto-shard", "2"]),
}
PP_SERVE_ARGS = ["--pipeline", "one-stage", "--num-inference-steps", "3", "--layers", str(PP_CLI_LAYERS),
                 *PP_CLI_SIZE[:6], "--device", "cuda"]
PP_HOP_BYTES = 50 * 2 ** 20  # the stage-2 clip's activation hop: 6144 tokens x 4096 x bf16
# Each rank's resident DiT weights under PP-2 against world 1's.
TOL_PP_WEIGHT_SHARE = 0.55


def _pp_cli_argv(name: str, directory: str, layout: bool, backend: str) -> list:
    """`generate.main`'s arguments of a PP_CLI_FLOWS run (with its layout
    flags and the world's backend when `layout`), its output an .mp4 (the
    no-ffmpeg save writes <base>_frames.npz: the frames themselves)."""
    import os

    base, flags = PP_CLI_FLOWS[name]
    out = os.path.join(directory, f"{name}_{'layout' if layout else 'world1'}.mp4")
    argv = [*base, "--layers", str(PP_CLI_LAYERS), *PP_CLI_SIZE, "--device", "cuda", "--output", out]
    if name == "keyframe_sp":
        argv += ["--keyframe", f"{directory}/first.png:0:1.0", "--keyframe", f"{directory}/last.png:24:0.95"]
    if name == "a2vid_sp":
        argv += ["--audio-file", f"{directory}/source.wav"]
    if layout:
        argv += [*flags, "--dist-backend", backend]
    return argv


def _pp_cli_inputs(directory: str) -> None:
    """The keyframes and the a2vid source the CLI runs read."""
    _write_png(f"{directory}/first.png", IMAGE_SEED, (256, 384))
    _write_png(f"{directory}/last.png", IMAGE_SEED + 1, (256, 384))
    _write_source_wav(f"{directory}/source.wav")


def _frames_of(mp4: str):
    import numpy as np

    with np.load(mp4[:-4] + "_frames.npz") as data:
        return data["frames"]


def _quiet_main(fn, argv: list) -> tuple:
    """fn(argv) with its stdout and stderr captured: (result, stdout, stderr)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn(argv)
    return result, out.getvalue(), err.getvalue()


def _so_pp_clip(rank: int, mesh, world: int) -> dict:
    """The PP-2 distilled clip: the DiT drawn as this rank's stage
    (SCALE_OUT_LAYERS fp8 blocks, every block drawn, the stage's kept), the
    clip decoded, then its stage-2 latent; each rank's resident weights,
    peak memory, bytes by operation and route, seconds and launches."""
    import torch

    from ltx2_tpu_torch.generate import generate_videos_distilled, make_dit
    from ltx2_tpu_torch.loader.fp8 import weight_bytes
    from ltx2_tpu_torch.parallel import collectives
    from ltx2_tpu_torch.parallel.pipeline_parallel import resident_blocks

    pipe = mesh.axis("pipe")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dit = make_dit(SCALE_OUT_LAYERS, torch.device("cuda"), fp8=True, pipe_axis=pipe)
    torch.cuda.synchronize()
    rec = {"dit_init_s": time.perf_counter() - t0, "resident_weights_gb": weight_bytes(dit) / 1e9,
           "resident_blocks": resident_blocks(dit), "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    before = _so_counts()
    t0 = time.perf_counter()
    out, stats = generate_videos_distilled([SCALE_OUT_SEED], height=HEIGHT, width=WIDTH, frames=FRAMES,
                                           layers=SCALE_OUT_LAYERS, device="cuda", dit=dit,
                                           meshes={"pipeline_mesh": mesh})
    rec.update(seconds=time.perf_counter() - t0, launches=_so_delta(before),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               bytes={k: dict(v) for k, v in collectives.STATS["bytes"].items()},
               bytes_sent=collectives.STATS["bytes_sent"], bytes_received=collectives.STATS["bytes_received"],
               calls=dict(collectives.STATS["calls"]), routes=dict(collectives.STATS["routes"]),
               stats={k: v for k, v in stats[0].items() if k.endswith("_s")})
    t0 = time.perf_counter()
    latent, _ = generate_videos_distilled([SCALE_OUT_SEED], height=HEIGHT, width=WIDTH, frames=FRAMES,
                                          layers=SCALE_OUT_LAYERS, device="cuda", dit=dit, skip_decode=True,
                                          meshes={"pipeline_mesh": mesh})
    rec["latent_run_s"] = time.perf_counter() - t0
    if rank == 0:
        rec["frames"], rec["latent"] = out[0], latent[0]
    del dit
    torch.cuda.empty_cache()
    return rec


def _so_hop_rate(rank: int, mesh) -> dict:
    """The pipeline's activation hop alone: PP_HOP_BYTES from stage 0 to
    stage 1 and back, on the route the world takes, 5 times after a warm
    one; bytes a second of one hop."""
    import torch

    from ltx2_tpu_torch.parallel.collectives import recv_start, route, send_start

    pipe = mesh.axis("pipe")
    x = torch.ones(PP_HOP_BYTES // 2, dtype=torch.bfloat16, device="cuda")

    def there_and_back():
        if pipe.index == 0:
            send_start([x], pipe, 1).wait()
            recv_start([x], pipe, 1).wait()
        else:
            y = recv_start([x], pipe, 0).wait()[0]
            send_start([y], pipe, 0).wait()
        torch.cuda.synchronize()

    there_and_back()
    t0 = time.perf_counter()
    for _ in range(5):
        there_and_back()
    seconds = (time.perf_counter() - t0) / 10
    return {"route": route(x, pipe, point_to_point=True), "bytes": PP_HOP_BYTES, "hop_s": seconds,
            "bytes_per_s": PP_HOP_BYTES / seconds}


def _so_cli(rank: int, world: int, backend: str, directory: str) -> dict:
    """The PP_CLI_FLOWS runs through `generate.main` with their layout flags
    (each rank's launches, seconds and stderr tail; rank 0 keeps the
    frames), then `serve.main` on the requests file with --pp-stages 2."""
    import torch

    from ltx2_tpu_torch import generate, serve
    from ltx2_tpu_torch.parallel import collectives

    rec = {}
    for name in PP_CLI_FLOWS:
        argv = _pp_cli_argv(name, directory, True, backend)
        collectives.reset_stats()
        before = _so_counts()
        t0 = time.perf_counter()
        _, out, err = _quiet_main(generate.main, argv)
        torch.cuda.synchronize()
        r = {"seconds": time.perf_counter() - t0, "launches": _so_delta(before), "stdout": out.strip(),
             "bytes_sent": collectives.STATS["bytes_sent"], "calls": dict(collectives.STATS["calls"])}
        if name == "auto_shard":
            r["choice"] = [line for line in err.splitlines() if line.startswith("--auto-shard")]
        if rank == 0:
            r["frames"] = _frames_of(argv[argv.index("--output") + 1])
        rec[name] = r
        torch.cuda.empty_cache()
    argv = [*PP_SERVE_ARGS, "--requests", f"{directory}/requests_served.jsonl", "--pp-stages", "2",
            "--dist-backend", backend]
    collectives.reset_stats()
    before = _so_counts()
    t0 = time.perf_counter()
    _, out, err = _quiet_main(serve.main, argv)
    rec["serve"] = {"seconds": time.perf_counter() - t0, "launches": _so_delta(before), "stdout": out.strip()}
    if rank == 0:
        rec["serve"]["frames"] = [_frames_of(f"{directory}/served_{i}.mp4") for i in range(2)]
    return rec


def _serve_requests(directory: str, tag: str) -> str:
    """Two JSON-lines requests (outputs `<tag>_<i>.mp4`); the file's path."""
    path = f"{directory}/requests_{tag}.jsonl"
    with open(path, "w") as f:
        for i in range(2):
            f.write(json.dumps({"output": f"{directory}/{tag}_{i}.mp4", "seed": SCALE_OUT_SEED + i}) + "\n")
    return path


def _scale_out_rank(rank: int, world: int, directory: str = "") -> dict:
    """One rank of phase_scale_out (under parallel.runtime.spawn_ranks): the
    ring check, the SP clip, the TP step and the decodes; then the PP-2
    clip and the activation hop's rate; then the command line's PP, SP,
    --auto-shard and server runs (`_so_cli`)."""
    import torch
    import torch.distributed as dist

    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = create_mesh(data=1, model=1, seq=world)
    tp = create_mesh(data=1, model=world)
    pp = create_mesh(data=1, model=1, pipe=world)
    rec = {"device": str(torch.cuda.current_device())}
    t0 = time.perf_counter()
    rec["ring"] = _so_ring(rank, world, seq)
    rec["ring"]["check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dit = make_dit(SCALE_OUT_LAYERS, torch.device("cuda"), fp8=True)
    rec["dit_init_s"] = time.perf_counter() - t0
    rec["sp_clip"] = _so_sp_clip(rank, seq, dit)
    t0 = time.perf_counter()
    rec["tp_step"] = _so_tp_step(rank, tp, dit)
    rec["tp_step"]["check_s"] = time.perf_counter() - t0
    del dit
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["decodes"] = _so_decodes(rank, world)
    rec["decodes"]["check_s"] = time.perf_counter() - t0
    rec["pp_clip"] = _so_pp_clip(rank, pp, world)
    rec["hop"] = _so_hop_rate(rank, pp)
    dist.barrier()
    t0 = time.perf_counter()
    rec["cli"] = _so_cli(rank, world, dist.get_backend(), directory)
    rec["cli"]["check_s"] = time.perf_counter() - t0
    return rec


def phase_scale_out(smi: str) -> tuple:
    """Sequence and tensor parallelism for serving, on the card, through the
    port's entry points: the world-1 SP reference clip here, then
    SCALE_OUT_WORLD ranks over gloo on the one card (over nccl too when the
    machine has a card per rank): ring attention at 1x32x6144^2x128 (K2
    twice per call per rank, held to K1 and the plain version), the SP-2
    distilled clip (SCALE_OUT_LAYERS fp8 blocks, stage 1 at 1536 tokens,
    stage 2 at 6144) against world 1, its frames and its stage-2 latent, a TP-2 step at 6144
    tokens against world 1 with each rank's peak memory, and the W-sharded
    and tile-parallel decodes against the unsharded one; the PP-2 clip (each
    rank's stage of the fp8 DiT) against world 1 with each rank's resident
    weights, bytes, seconds and launches, and the activation hop's rate;
    then through the command line at full width and PP_CLI_LAYERS blocks
    (each against world 1's run here): one-stage CFG at --pp-stages 2,
    keyframe and a2vid at --sp-devices 2 --vae-w-shard 2, distilled at
    --auto-shard 2, and serve.py with --pp-stages 2 on two requests.
    Returns (record, the ranks' main-path counts by path)."""
    import datetime
    import tempfile

    import numpy as np
    import torch

    from ltx2_tpu_torch import generate, serve
    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.loader.fp8 import weight_bytes
    from ltx2_tpu_torch.parallel.runtime import spawn_ranks

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    k2 = _residuals_case(smi)
    t0 = time.perf_counter()
    dit = make_dit(SCALE_OUT_LAYERS, torch.device("cuda"), fp8=True)
    ref_frames, ref_stats = _so_clip(dit)
    world1_s = time.perf_counter() - t0
    ref_latent, _ = _so_clip(dit, skip_decode=True)
    world1_weights_gb = weight_bytes(dit) / 1e9
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    cli_dir = tempfile.mkdtemp(prefix="ltx_scale_out_cli_")
    _pp_cli_inputs(cli_dir)
    for tag in ("world1", "served"):
        _serve_requests(cli_dir, tag)
    t0 = time.perf_counter()
    cli_ref = {}
    for name in PP_CLI_FLOWS:
        argv = _pp_cli_argv(name, cli_dir, False, "")
        _quiet_main(generate.main, argv)
        cli_ref[name] = _frames_of(argv[argv.index("--output") + 1])
        torch.cuda.empty_cache()
    _, served_ref, _ = _quiet_main(serve.main, [*PP_SERVE_ARGS, "--requests", f"{cli_dir}/requests_world1.jsonl"])
    serve_ref = [_frames_of(f"{cli_dir}/world1_{i}.mp4") for i in range(2)]
    world1_cli_s = time.perf_counter() - t0
    routes = [("gloo", SCALE_OUT_WORLD)]
    if torch.cuda.device_count() >= SCALE_OUT_WORLD:
        routes.append(("nccl", SCALE_OUT_WORLD))
    record, counts = {"world_1_clip_s": world1_s, "world_1_cli_s": world1_cli_s, "k2_case": k2,
                      "world_1_weights_gb": world1_weights_gb, "routes": {}}, {}
    for backend, world in routes:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="ltx_scale_out_") as directory:
            ranks = spawn_ranks(_scale_out_rank, world, directory, cli_dir, backend=backend, device="cuda",
                                timeout=SCALE_OUT_TIMEOUT_S,
                                collective_timeout=datetime.timedelta(seconds=SCALE_OUT_PG_TIMEOUT_S))
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        frames, latent = r0["sp_clip"].pop("frames"), r0["sp_clip"].pop("latent")
        levels = _frame_diff(frames, ref_frames)
        latent_err = _mismatch(torch.from_numpy(latent), torch.from_numpy(ref_latent))
        sp = {"frames_vs_world_1": levels, "latent_vs_world_1": latent_err, "tol_mean_levels": TOL_SP_MEAN_LEVELS,
              "tol_latent_rms_rel": TOL_SP_LATENT_RMS_REL}
        if frames.shape != ref_frames.shape or not np.isfinite(frames).all() \
                or levels["mean_levels"] > TOL_SP_MEAN_LEVELS:
            raise AssertionError(f"SP-{world} clip over {backend} against world 1: {levels} (mean limit "
                                 f"{TOL_SP_MEAN_LEVELS})")
        if latent.shape != ref_latent.shape or not latent_err["finite"] \
                or latent_err["rms_rel_err"] > TOL_SP_LATENT_RMS_REL:
            raise AssertionError(f"SP-{world} stage-2 latent over {backend} against world 1: {latent_err} (rms "
                                 f"limit {TOL_SP_LATENT_RMS_REL})")
        per_rank = [{k: r[k] for k in ("ring", "sp_clip", "tp_step", "decodes", "dit_init_s")} for r in ranks]
        for i, r in enumerate(per_rank):
            log(f"scale-out rank {i} over {backend}: ring {r['ring']['ms']:.2f} ms a call ({r['ring']['bytes_per_call']}"
                f"), SP clip {r['sp_clip']['seconds']:.1f} s (peak {r['sp_clip']['peak_gb']:.1f} GB, sent "
                f"{r['sp_clip']['bytes_sent'] / 1e9:.2f} GB, launches {r['sp_clip']['launches']}), TP step "
                f"{r['tp_step']['seconds']:.2f} s (peak {r['tp_step']['peak_gb']:.1f} GB, weights "
                f"{r['tp_step']['resident_weights_gb']:.1f} GB, sent {r['tp_step']['bytes_sent'] / 1e9:.2f} GB), "
                f"W-sharded decode {r['decodes']['w_sharded']['seconds']:.1f} s (W-valid convs "
                f"{r['decodes']['w_sharded']['launches']['conv_w_valid']}), tile-parallel decode "
                f"{r['decodes']['tile_parallel']['seconds']:.1f} s | {smi}")
        record["routes"][backend] = {
            "world": world, "wall_s": wall, "sp_clip": sp,
            "ring_vs_k1": r0["ring"]["vs_k1"], "ring_vs_plain": r0["ring"]["vs_plain"],
            "ring_k1_ms": r0["ring"]["k1_ms"], "tp_x0_vs_world_1": r0["tp_step"]["vs_world_1"],
            "w_sharded_vs_unsharded": {k: r0["decodes"]["w_sharded"][k] for k in ("max_abs", "rms", "bitwise")},
            "tile_parallel_vs_unsharded": {k: r0["decodes"]["tile_parallel"][k]
                                           for k in ("max_abs", "rms", "bitwise")},
            "per_rank": per_rank,
        }
        log(f"scale-out over {backend} ({world} ranks on {torch.cuda.device_count()} card(s)): "
            f"{json.dumps({k: v for k, v in record['routes'][backend].items() if k != 'per_rank'})} | {smi}")
        # The path's counts, summed over the ranks: the SP clip (K1, K2 and
        # the decode's convs) and the W-sharded decode (the W-valid convs).
        counts[backend] = {k: sum(r["sp_clip"]["launches"][k] + r["decodes"]["w_sharded"]["launches"][k]
                                  + r["decodes"]["tile_parallel"]["launches"][k] for r in per_rank)
                           for k in ("fwd", "residuals", "conv", "conv_w_valid")}
        if not all(counts[backend][k] for k in ("fwd", "residuals", "conv_w_valid")):
            raise AssertionError(f"scale-out over {backend}: a kernel of the path never launched: {counts[backend]}")
        pp_rec, pp_counts = _so_pp_checks(backend, ranks, ref_frames, ref_latent, ref_stats, world1_weights_gb,
                                          cli_ref, serve_ref, served_ref, smi)
        record["routes"][backend].update(pp_rec)
        counts.update({f"{backend}_{path}": c for path, c in pp_counts.items()})
    shutil.rmtree(cli_dir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"scale-out phase: {record['seconds']:.1f} s, launches on its paths {json.dumps(counts)} | {smi}")
    return record, counts


def _so_pp_checks(backend: str, ranks: list, ref_frames, ref_latent, ref_stats: dict, world1_weights_gb: float,
                  cli_ref: dict, serve_ref: list, served_ref: str, smi: str) -> tuple:
    """phase_scale_out's gates on the PP clip and the command line's runs
    of one route: (record, launches by path, summed over the ranks). Each
    path must launch its kernels: K1 on every rank of the PP clip, summed
    to world 1's count; K2 and the W-valid conv on the SP runs."""
    import numpy as np
    import torch

    r0 = ranks[0]
    frames, latent = r0["pp_clip"].pop("frames"), r0["pp_clip"].pop("latent")
    levels = _frame_diff(frames, ref_frames)
    latent_err = _mismatch(torch.from_numpy(latent), torch.from_numpy(ref_latent))
    pp = {"frames_vs_world_1": levels, "latent_vs_world_1": latent_err,
          "bitwise": bool(np.array_equal(frames, ref_frames) and np.array_equal(latent, ref_latent)),
          "world_1_fwd_launches": ref_stats["attention_launches"],
          "per_rank": [{k: v for k, v in r["pp_clip"].items()} for r in ranks], "hop": [r["hop"] for r in ranks]}
    if frames.shape != ref_frames.shape or not np.isfinite(frames).all() \
            or levels["mean_levels"] > TOL_SP_MEAN_LEVELS:
        raise AssertionError(f"PP-2 clip over {backend} against world 1: {levels} (mean limit {TOL_SP_MEAN_LEVELS})")
    if latent.shape != ref_latent.shape or not latent_err["finite"] \
            or latent_err["rms_rel_err"] > TOL_SP_LATENT_RMS_REL:
        raise AssertionError(f"PP-2 stage-2 latent over {backend} against world 1: {latent_err} (rms limit "
                             f"{TOL_SP_LATENT_RMS_REL})")
    fwd = [r["pp_clip"]["launches"]["fwd"] for r in ranks]
    if min(fwd) == 0 or sum(fwd) != ref_stats["attention_launches"]:
        raise AssertionError(f"PP-2 clip over {backend}: K1 launches by rank {fwd}, world 1 "
                             f"{ref_stats['attention_launches']}")
    for i, r in enumerate(ranks):
        share = r["pp_clip"]["resident_weights_gb"] / world1_weights_gb
        if share > TOL_PP_WEIGHT_SHARE:
            raise AssertionError(f"PP-2 rank {i}: resident DiT weights {r['pp_clip']['resident_weights_gb']:.2f} GB, "
                                 f"{share:.3f} of world 1's (limit {TOL_PP_WEIGHT_SHARE})")
        log(f"PP-2 clip rank {i} over {backend}: blocks {r['pp_clip']['resident_blocks'][0]}-"
            f"{r['pp_clip']['resident_blocks'][-1]}, resident DiT {r['pp_clip']['resident_weights_gb']:.2f} GB "
            f"({share:.3f} of world 1's {world1_weights_gb:.2f}), peak {r['pp_clip']['peak_gb']:.2f} GB (init "
            f"{r['pp_clip']['init_peak_gb']:.2f}), {r['pp_clip']['seconds']:.2f} s, K1 launches "
            f"{r['pp_clip']['launches']['fwd']}, bytes {json.dumps(r['pp_clip']['bytes'])}, hop "
            f"{json.dumps(r['hop'])} | {smi}")
    counts = {"pp_clip": {k: sum(r["pp_clip"]["launches"][k] for r in ranks)
                          for k in ("fwd", "residuals", "conv", "conv_w_valid")}}
    cli = {}
    for name in (*PP_CLI_FLOWS, "serve"):
        got = r0["cli"][name].pop("frames")
        ref = serve_ref if name == "serve" else cli_ref[name]
        pairs = list(zip(got, ref)) if name == "serve" else [(got, ref)]
        diffs = [_frame_diff(a, b) for a, b in pairs]
        if any(a.shape != b.shape for a, b in pairs) or any(d["mean_levels"] > TOL_SP_MEAN_LEVELS for d in diffs):
            raise AssertionError(f"{name} over {backend} against world 1: {diffs} (mean limit {TOL_SP_MEAN_LEVELS})")
        c = {k: sum(r["cli"][name]["launches"][k] for r in ranks) for k in ("fwd", "residuals", "conv",
                                                                          "conv_w_valid")}
        need = ("fwd", "residuals", "conv_w_valid") if name in ("keyframe_sp", "a2vid_sp") else ("fwd",)
        if not all(c[k] for k in need) or not all(r["cli"][name]["launches"]["fwd"] for r in ranks):
            raise AssertionError(f"{name} over {backend}: a kernel of the path never launched: {c} (by rank "
                                 f"{[r['cli'][name]['launches'] for r in ranks]})")
        counts[name] = c
        cli[name] = {"vs_world_1": diffs, "bitwise": all(np.array_equal(a, b) for a, b in pairs),
                     "seconds": [r["cli"][name]["seconds"] for r in ranks], "launches": c}
        if name == "auto_shard":
            cli[name]["choice"] = r0["cli"][name]["choice"]
    served = [r["cli"]["serve"]["stdout"] for r in ranks]
    responses = [json.loads(line) for line in served[0].splitlines()]
    if len(responses) != 2 or any(x["status"] != "ok" for x in responses) or any(served[1:]):
        raise AssertionError(f"serve.py over {backend} on {len(ranks)} ranks: rank 0 printed {served[0]!r}, the "
                             f"others {served[1:]!r}")
    cli["serve"]["other_ranks_stdout"] = served[1:]
    cli["serve"]["world_1_lines"] = len(served_ref.splitlines())
    log(f"PP-2 clip over {backend}: {json.dumps({k: v for k, v in pp.items() if k != 'per_rank'})} | {smi}")
    log(f"scale-out command line over {backend}: {json.dumps(cli)} | {smi}")
    return {"pp_clip": pp, "cli": cli}, counts


def main():
    from pathlib import Path

    import ltx2_tpu_torch  # fails outside a checkout, before any result

    t_start = time.perf_counter()
    clock = [("start", t_start)]  # (phase, when it ended): the seconds each took, logged at the end

    here = Path(__file__).resolve().parent
    if Path(ltx2_tpu_torch.__file__).resolve().parent.parent != here:
        log(f"chip_smoke: ltx2_tpu_torch comes from {ltx2_tpu_torch.__file__}, not this checkout {here}")
        sys.exit(2)
    smi = phase_device()
    clock.append(("device", time.perf_counter()))
    phase_build()
    clock.append(("build", time.perf_counter()))
    recs = phase_kernels()
    clock.append(("kernels", time.perf_counter()))
    conv_recs = phase_conv_kernels()
    clock.append(("conv_kernels", time.perf_counter()))
    upscaler_conv = phase_upscaler_conv_time(conv_recs, smi)
    clock.append(("upscaler_conv_time", time.perf_counter()))
    serve_counts, serve = phase_main_path(smi)
    clock.append(("main_path", time.perf_counter()))

    import torch

    torch.cuda.empty_cache()
    fp8_step, int8_counts = phase_fp8_step(smi)
    clock.append(("fp8_step", time.perf_counter()))
    temporal, temporal_counts = phase_temporal_upscale(smi)
    clock.append(("temporal_upscale", time.perf_counter()))
    text_encode = phase_text_encode(smi)
    clock.append(("text_encode", time.perf_counter()))
    checkpoint, file_counts, file_stats = phase_checkpoint(smi)
    clock.append(("checkpoint", time.perf_counter()))
    torch.cuda.empty_cache()
    v2_files, v2_counts = phase_v2_files(smi)
    clock.append(("v2_files", time.perf_counter()))
    server_counts = v2_files["server"]["launches"]
    served_mp4_counts = v2_files["server"]["served_mp4_launches"]  # counted in server_counts too
    torch.cuda.empty_cache()
    two_stage_counts, two_stage_stats, two_stage_peaks = phase_two_stage(smi)
    clock.append(("two_stage", time.perf_counter()))
    phases = ("text_encode", "stage1", "upscale", "stage2", "decode")
    checkpoint["two_stage"]["bf16_random_seconds"] = {p: [s[f"{p}_s"] for s in two_stage_stats] for p in phases}
    checkpoint["two_stage"]["bf16_random_peak_gb"] = {p: two_stage_peaks[f"{p}_peak_gb"] for p in phases}
    side_by_side = {k: checkpoint["two_stage"][k]
                    for k in ("seconds", "peak_gb", "bf16_random_seconds", "bf16_random_peak_gb")}
    log(f"two-stage from the files (fp8 DiT, 2-layer Gemma) beside the bf16 random-weight flow: "
        f"{json.dumps(side_by_side)} | {smi}")
    torch.cuda.empty_cache()
    two_stage_small = phase_two_stage_small(smi)
    clock.append(("two_stage_small", time.perf_counter()))
    v2_small = phase_two_stage_small(smi, v2=True)
    clock.append(("two_stage_small", time.perf_counter()))
    audio_check = phase_audio_decode_check(smi)
    clock.append(("audio_decode_check", time.perf_counter()))
    av_small = phase_av_small(smi)
    clock.append(("av_small", time.perf_counter()))
    mm_small = phase_two_stage_cfg_small(smi)
    clock.append(("two_stage_cfg_small", time.perf_counter()))
    av, av_counts, a2vid, a2vid_counts = phase_av_two_stage(smi)
    clock.append(("av_two_stage", time.perf_counter()))
    av["av_step_vs_video_step_ms"] = {"av_fp8": av["av_step"]["device_ms"], "video_fp8": fp8_step["fp8"]["device_ms"],
                                      "av_layers": AV_TWO_STAGE_LAYERS, "video_layers": LAYERS}
    log(f"AV vs video-only fp8 DiT step (6144 tokens): {json.dumps(av['av_step_vs_video_step_ms'])}"
        f" | {smi}")
    av_files, av_file_counts = phase_av_files(smi)
    clock.append(("av_files", time.perf_counter()))
    torch.cuda.empty_cache()
    two_cfg, two_cfg_counts = phase_two_stage_cfg(smi)
    clock.append(("two_stage_cfg", time.perf_counter()))
    log(f"AV stage-1 step at 1536 tokens, bf16: 3 rows (two-stage CFG) "
        f"{two_cfg['stage1_step_3_rows']['device_ms']:.1f} ms device, 1 row (distilled) "
        f"{two_cfg['stage1_step_1_row']['device_ms']:.1f} ms | {smi}")
    torch.cuda.empty_cache()
    stills = phase_stills(smi)
    clock.append(("stills", time.perf_counter()))
    i2v_two_stage, i2v_one_stage, options, image_to_video = phase_image_to_video(smi)
    clock.append(("image_to_video", time.perf_counter()))
    torch.cuda.empty_cache()
    keyframe_hq, kf_counts = phase_keyframe_and_hq(smi)
    clock.append(("keyframe_and_hq", time.perf_counter()))
    torch.cuda.empty_cache()
    video_paths, vp_counts = phase_video_paths(smi)
    clock.append(("video_paths", time.perf_counter()))
    torch.cuda.empty_cache()
    full_vae, fv_counts = phase_full_vae(smi)
    clock.append(("full_vae", time.perf_counter()))
    torch.cuda.empty_cache()
    webp = phase_webp(smi)
    clock.append(("webp", time.perf_counter()))
    torch.cuda.empty_cache()
    scale_out, so_counts = phase_scale_out(smi)
    clock.append(("scale_out", time.perf_counter()))
    torch.cuda.empty_cache()
    bwd = phase_bwd_kernels()
    clock.append(("bwd_kernels", time.perf_counter()))
    model, train_counts = phase_train_steps(smi)
    clock.append(("train_steps", time.perf_counter()))
    timing = phase_train_timing(model, smi)
    clock.append(("train_timing", time.perf_counter()))
    del model
    torch.cuda.empty_cache()
    gradcheck = phase_train_gradcheck(smi)
    clock.append(("train_gradcheck", time.perf_counter()))
    av_train = phase_training_av(smi)
    clock.append(("training_av", time.perf_counter()))
    train_dp, dp_counts = phase_train_dp(smi)
    clock.append(("train_dp", time.perf_counter()))
    train_tp, tp_counts, tp_world1 = phase_train_tp(smi)
    clock.append(("train_tp", time.perf_counter()))
    train_fsdp, fsdp_counts = phase_train_fsdp(smi, tp_world1)
    clock.append(("train_fsdp", time.perf_counter()))
    del tp_world1
    dp_counts = {**dp_counts, **tp_counts, **fsdp_counts}  # the scale-out training paths, DP, TP, FSDP
    # The training paths of the AV slice and their launch counts, each read
    # right after the path ran (the resume path's: the uninterrupted run).
    av_paths = {"train_av": av_train["train_av_counts"], "train_av_fp8": av_train["train_av_fp8_counts"],
                "train_av_video_only": av_train["video_only_counts"], "train_resume": av_train["resume_counts"]}
    audio_only_counts, prep_counts = av_train["audio_only_counts"], av_train["prepare_data_counts"]
    log(f"AV LoRA step vs video-only step at 6144 video tokens (1024 text tokens): AV bf16 "
        f"{av_train['train_av']['timing']['ms_per_step']:.1f} ms, AV fp8 base "
        f"{av_train['train_av_fp8']['timing']['ms_per_step']:.1f} ms ({AV_TRAIN_LAYERS} blocks), video-only bf16 "
        f"{timing['ms_per_step']:.1f} ms ({LAYERS} blocks) | {smi}")

    self_rec, self_bwd = recs[0], bwd[0]
    bf16_recs = [r for r in conv_recs if r["dtype"] == "bfloat16"]
    w_valid_recs = [r for r in conv_recs if r["w_valid"]]  # the bf16 one first
    fp32_recs = [r for r in conv_recs if r["dtype"] == "float32"]  # "upscaler" first
    upscale_launches = sum(s["upscale_conv_launches"] for s in two_stage_stats)
    file_upscale_launches = sum(s["upscale_conv_launches"] for s in file_stats)
    # Keyframe and ti2vid-hq: the decode's convs on the bf16 kernel, the
    # encoder's and the upscaler's on the fp32 one.
    kf_bf16 = {k: keyframe_hq[k]["decode_conv_launches"] for k in ("keyframe", "ti2vid_hq")}
    kf_fp32 = {k: c["conv"] - kf_bf16.get(k, 0) for k, c in kf_counts.items()}
    # Retake, ic-lora and prepare_data --videos: the decodes' convs on the
    # bf16 kernel; the encoder's (source, control, clips) and the upscaler's
    # on the fp32 one. The small ic-lora run decodes nothing.
    vp_bf16 = {k: vp_counts[k]["conv_bf16"] for k in ("retake", "ic_lora", "ic_lora_canny", "av_mjpeg")}
    vp_fp32 = {**{k: vp_counts[k]["conv_fp32"] for k in ("retake", "ic_lora", "ic_lora_canny", "av_mjpeg")},
               "ic_lora_small": vp_counts["ic_lora_small"]["conv"],
               "prepare_data_videos": vp_counts["prepare_data_videos"]["conv"]}
    # The full VAE: the encoders and the dual-conv mid block on the fp32
    # kernel, the decoder on the bf16 one.
    fv_fp32 = {f"full_vae_{k}": fv_counts[k]["conv"] for k in ("encoder", "encoder_strided", "mid_block_dual")}
    fv_strided = {f"full_vae_{k}": c["strided"] for k, c in fv_counts.items()}
    conv_replaces = ("scripts/bench_conv_pallas.py:116 (conv3d_pallas, pallas_call :140); "
                     "scripts/bench_conv_pallas.py:223 (conv3d_pallas_v2, pallas_call :247); "
                     "scripts/bench_conv_pallas.py:357 (conv3d_pallas_v3, pallas_call :378)")
    record = {"kernels": [
        {
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ltx2_tpu/ops/attention.py:188",
            "launches": (serve_counts["fwd"] + two_stage_counts["fwd"] + file_counts["fwd"] + v2_counts["fwd"]
                         + av_counts["fwd"] + av_file_counts["fwd"] + two_cfg_counts["fwd"] + a2vid_counts["fwd"]
                         + i2v_two_stage["fwd"] + i2v_one_stage["fwd"] + options["fwd"] + train_counts["fwd"]
                         + sum(c["fwd"] for c in av_paths.values()) + audio_only_counts["fwd"]
                         + int8_counts["fwd"] + temporal_counts["fwd"] + sum(c["fwd"] for c in kf_counts.values())
                         + sum(c["fwd"] for c in vp_counts.values()) + server_counts["fwd"]
                         + sum(c["fwd"] for c in so_counts.values()) + sum(c["fwd"] for c in dp_counts.values())),
            "launches_by_path": {"serve": serve_counts["fwd"], "serve_two_stage": two_stage_counts["fwd"],
                                 "serve_two_stage_from_files": file_counts["fwd"],
                                 "serve_v2_two_stage_from_files": v2_counts["fwd"],
                                 "serve_av_two_stage": av_counts["fwd"],
                                 "serve_v2_av_two_stage_from_files": av_file_counts["fwd"],
                                 "serve_two_stage_cfg": two_cfg_counts["fwd"], "serve_a2vid": a2vid_counts["fwd"],
                                 "image_to_video_two_stage": i2v_two_stage["fwd"],
                                 "one_stage": i2v_one_stage["fwd"], "one_stage_options": options["fwd"],
                                 "train": train_counts["fwd"], **{k: c["fwd"] for k, c in av_paths.items()},
                                 "audio_only": audio_only_counts["fwd"], "serve_int8": int8_counts["fwd"],
                                 "temporal_upscale": temporal_counts["fwd"],
                                 **{k: c["fwd"] for k, c in kf_counts.items()},
                                 **{k: c["fwd"] for k, c in vp_counts.items()}, "server": server_counts["fwd"],
                                 **{f"scale_out_{b}": c["fwd"] for b, c in so_counts.items()},
                                 **{k: c["fwd"] for k, c in dp_counts.items()}},
            # The served .mp4 request (no ffmpeg: MJPEG .mp4, GIF, npz), counted in "server" too.
            "served_mp4_launches": served_mp4_counts["fwd"],
            # ic-lora's stage 1 over its 1536 tokens and the control's 1536
            # appended, counted in "launches" too.
            "ic_lora_launches_by_length": vp_counts["ic_lora"]["by_length"],
            # Keyframe interpolation's lengths past the tile grid (keyframes
            # appended), counted in "launches" too.
            "keyframe_launches_by_length": kf_counts["keyframe"]["by_length"],
            # The key-valid route (ltx2_tpu/ops/attention.py:222, _flash_attention_masked), counted in
            # "launches" too: the token bucket's self-attention.
            "key_valid_launches": (options["key_valid"] + sum(c["key_valid"] for c in av_paths.values())
                                   + audio_only_counts["key_valid"]),
            "key_valid_launches_by_path": {"one_stage_options": options["key_valid"],
                                           **{k: c["key_valid"] for k, c in av_paths.items()},
                                           "audio_only": audio_only_counts["key_valid"]},
            # The D = 64 instantiation on the audio-video paths, counted in "launches" too.
            "head_dim_64_launches_by_path": {"serve_av_two_stage": av_counts["fwd_by_head_dim"].get(64, 0),
                                             "serve_v2_av_two_stage_from_files":
                                                 av_file_counts["fwd_by_head_dim"].get(64, 0),
                                             "serve_two_stage_cfg": two_cfg_counts["fwd_by_head_dim"].get(64, 0),
                                             "serve_a2vid": a2vid_counts["fwd_by_head_dim"].get(64, 0),
                                             **{k: c["fwd_by_head_dim"].get(64, 0) for k, c in av_paths.items()},
                                             "audio_only": audio_only_counts["fwd_by_head_dim"].get(64, 0),
                                             "ti2vid_hq_av": kf_counts["ti2vid_hq_av"]["by_head_dim"].get(64, 0)},
            "launches_by_head_dim": {**{k: c["fwd_by_head_dim"] for k, c in av_paths.items()},
                                     "audio_only": audio_only_counts["fwd_by_head_dim"]},
            # The multi-modal guider's rows at batch 3 (two-stage CFG stage 1), counted in "launches" too.
            "batch_3_launches_by_path": {"serve_two_stage_cfg": two_cfg_counts["fwd_by_batch"].get(3, 0)},
            # ti2vid-hq's Res2s stage 1: the prompt and negative rows at batch 2.
            "batch_2_launches_by_path": {"ti2vid_hq": kf_counts["ti2vid_hq"]["by_batch"].get(2, 0),
                                         "retake": vp_counts["retake"]["fwd_by_batch"].get(2, 0)},
            "max_abs_err": max(max(r["max_abs_err"] for r in recs),
                               max(r["max_abs_err_fwd_residuals"] for r in bwd)),
            "ms": self_rec["ms"],
            "kernel_ms": self_rec["kernel_ms"],
            "plain_ms": self_rec["plain_ms"],
            "bound_ms": self_rec["bound_ms"],
            "bound_by": self_rec["bound_by"],
            "library_ms": self_rec["library_ms"],
            "cases": recs,
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 (_flash_attention_bwd_dkv, "
                        "pallas_call :1121) and :1287 (_flash_attention_bwd_dq, pallas_call :1456); reached from "
                        "ltx2_tpu/ops/attention.py:188",
            "launches": (train_counts["bwd"] + sum(c["bwd"] for c in av_paths.values())
                         + sum(c["bwd"] for c in dp_counts.values())),
            "launches_by_path": {"train": train_counts["bwd"], **{k: c["bwd"] for k, c in av_paths.items()},
                                 **{k: c["bwd"] for k, c in dp_counts.items()}},
            "launches_by_head_dim": {"train": train_counts["bwd_by_head_dim"],
                                     **{k: c["bwd_by_head_dim"] for k, c in av_paths.items()}},
            "max_abs_err": max(r["max_abs_err_grads"] for r in bwd),
            "ms": self_bwd["kernel_events_ms"],
            "kernel_ms": self_bwd["kernel_ms"],
            "whole_bwd_ms": self_bwd["bwd_ms"],
            "plain_ms": self_bwd["plain_ms"],
            "bound_ms": self_bwd["bound_ms"],
            "bound_by": self_bwd["bound_by"],
            "library_ms": self_bwd["library_ms"],
            "cases": bwd,
        },
        {
            "name": "conv3d_implicit_gemm",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/conv3d.cu",
            "kernel": "conv3d_wgmma_kernel",
            "replaces": conv_replaces,
            "launches": (serve_counts["conv"] + two_stage_counts["conv"] - upscale_launches
                         + file_counts["conv"] - file_upscale_launches + v2_counts["conv_bf16"]
                         + av_counts["conv_bf16"] + av_file_counts["conv_bf16"]
                         + two_cfg_counts["conv_bf16"] + a2vid_counts["conv_bf16"]
                         + i2v_two_stage["conv_bf16"] + i2v_one_stage["conv_bf16"] + options["conv_bf16"]
                         + temporal_counts["conv_bf16"] + sum(kf_bf16.values()) + sum(vp_bf16.values())
                         + server_counts["conv_bf16"] + fv_counts["decoder"]["conv"]),
            "launches_by_path": {"serve": serve_counts["conv"],
                                 "serve_two_stage": two_stage_counts["conv"] - upscale_launches,
                                 "serve_two_stage_from_files": file_counts["conv"] - file_upscale_launches,
                                 "serve_v2_two_stage_from_files": v2_counts["conv_bf16"],
                                 "serve_av_two_stage": av_counts["conv_bf16"],
                                 "serve_v2_av_two_stage_from_files": av_file_counts["conv_bf16"],
                                 "serve_two_stage_cfg": two_cfg_counts["conv_bf16"],
                                 "serve_a2vid": a2vid_counts["conv_bf16"],
                                 "image_to_video_two_stage": i2v_two_stage["conv_bf16"],
                                 "one_stage": i2v_one_stage["conv_bf16"],
                                 "one_stage_options": options["conv_bf16"],
                                 "temporal_upscale": temporal_counts["conv_bf16"], **kf_bf16, **vp_bf16,
                                 "server": server_counts["conv_bf16"],
                                 "full_vae_decoder": fv_counts["decoder"]["conv"]},
            "served_mp4_launches": served_mp4_counts["conv_bf16"],  # counted in "server" too
            "max_abs_err": max(r["max_abs_err"] for r in bf16_recs),
            "ms": bf16_recs[0]["ms"],
            "plain_ms": bf16_recs[0]["plain_ms"],
            "bound_ms": bf16_recs[0]["bound_ms"],
            "bound_by": bf16_recs[0]["bound_by"],
            "library_ms": bf16_recs[0]["library_ms"],
            "cases": bf16_recs,
        },
        {
            "name": "conv3d_tf32x3",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/conv3d.cu",
            "kernel": "conv3d_tf32x3_kernel",
            "replaces": conv_replaces,
            "launches": (upscale_launches + file_upscale_launches + v2_counts["conv_fp32"]
                         + av_counts["conv_fp32"] + av_file_counts["conv_fp32"]
                         + two_cfg_counts["conv_fp32"] + a2vid_counts["conv_fp32"]
                         + i2v_two_stage["conv_fp32"] + i2v_one_stage["conv_fp32"] + options["conv_fp32"]
                         + prep_counts["conv"] + temporal_counts["conv_fp32"] + sum(kf_fp32.values())
                         + sum(vp_fp32.values()) + server_counts["conv_fp32"] + sum(fv_fp32.values())),
            "launches_by_path": {"serve_two_stage": upscale_launches,
                                 "serve_two_stage_from_files": file_upscale_launches,
                                 "serve_v2_two_stage_from_files": v2_counts["conv_fp32"],
                                 "serve_av_two_stage": av_counts["conv_fp32"],
                                 "serve_v2_av_two_stage_from_files": av_file_counts["conv_fp32"],
                                 "serve_two_stage_cfg": two_cfg_counts["conv_fp32"],
                                 "serve_a2vid": a2vid_counts["conv_fp32"],
                                 "image_to_video_two_stage": i2v_two_stage["conv_fp32"],
                                 "one_stage": i2v_one_stage["conv_fp32"],
                                 "one_stage_options": options["conv_fp32"], "prepare_data": prep_counts["conv"],
                                 "temporal_upscale": temporal_counts["conv_fp32"], **kf_fp32, **vp_fp32,
                                 "server": server_counts["conv_fp32"], **fv_fp32},
            # The strided launches (the full VAE's compress_* convs), counted in "launches" too.
            "strided_launches_by_path": fv_strided,
            "served_mp4_launches": served_mp4_counts["conv_fp32"],  # counted in "server" too
            "max_abs_err": max(r["max_abs_err"] for r in fp32_recs),
            "ms": fp32_recs[0]["ms"],
            "plain_ms": fp32_recs[0]["plain_ms"],
            "bound_ms": fp32_recs[0]["bound_ms"],
            "bound_by": fp32_recs[0]["bound_by"],
            "ffma_bound_ms": fp32_recs[0]["ffma_bound_ms"],
            "library_ms": fp32_recs[0]["library_ms"],
            "upscaler_conv_time": upscaler_conv,
            "cases": fp32_recs,
        },
        {
            "name": "flash_attention_residuals",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ltx2_tpu/parallel/ring_attention.py:165 (_flash_impl_residuals)",
            # The ring's inner on the scale-out path (counted in flash_attention_fwd's launches too).
            "launches": sum(c["residuals"] for c in so_counts.values()),
            "launches_by_path": {f"scale_out_{b}": c["residuals"] for b, c in so_counts.items()},
            "max_abs_err": max(scale_out["k2_case"]["max_abs_err"],
                               *(r["ring_vs_plain"]["max_abs_err"] for r in scale_out["routes"].values())),
            "ms": scale_out["k2_case"]["ms"],
            "kernel_ms": scale_out["k2_case"]["kernel_ms"],
            "kernel_events_ms": scale_out["k2_case"]["kernel_events_ms"],
            "plain_ms": scale_out["k2_case"]["plain_ms"],
            "bound_ms": scale_out["k2_case"]["bound_ms"],
            "bound_by": scale_out["k2_case"]["bound_by"],
            "library_ms": scale_out["k2_case"]["library_ms"],
            "cases": [scale_out["k2_case"]],
        },
        {
            "name": "conv3d_w_valid",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/conv3d.cu",
            "kernel": "conv3d_wgmma_kernel and conv3d_tf32x3_kernel in their W-valid mode (the kStrided instances)",
            "replaces": conv_replaces + "; the W halo of ltx2_tpu/models/video_vae/conv.py:34-84,110-127",
            "launches": sum(c["conv_w_valid"] for c in so_counts.values()),
            "launches_by_path": {f"scale_out_{b}": c["conv_w_valid"] for b, c in so_counts.items()},
            "max_abs_err": max(r["max_abs_err"] for r in w_valid_recs),
            "ms": w_valid_recs[0]["ms"],
            "kernel_ms": w_valid_recs[0]["kernel_ms"],
            "plain_ms": w_valid_recs[0]["plain_ms"],
            "bound_ms": w_valid_recs[0]["bound_ms"],
            "bound_by": w_valid_recs[0]["bound_by"],
            "library_ms": w_valid_recs[0]["library_ms"],
            "cases": w_valid_recs,
        },
    ], "train": {"timing": timing, "gradcheck": gradcheck,
                  "audio_video": {k: v for k, v in av_train.items() if not k.endswith("_counts")},
                  "data_parallel": train_dp, "tensor_parallel": train_tp, "fsdp": train_fsdp},
        "bench_e2e": serve, "fp8_step": fp8_step, "checkpoint": checkpoint, "temporal_upscaler": temporal,
        "keyframe_and_ti2vid_hq": keyframe_hq, "video_paths": video_paths, "full_vae": full_vae, "webp": webp,
        "scale_out": scale_out, "stills": stills,
        "text_encode": text_encode, "image_to_video": image_to_video,
        "v2": {"files": v2_files, "small_input_check": v2_small,
               "step_ms": {"v2_bf16": fp8_step["v2_bf16"]["device_ms"], "v1_bf16": fp8_step["bf16"]["device_ms"]}},
        "two_stage": {"requests": two_stage_stats, "peak_memory_gb_by_phase": two_stage_peaks,
                      "small_input_check": two_stage_small},
        "audio_video": {"two_stage": av, "small_input_check": av_small, "from_files": av_files,
                        "audio_decode_card_vs_cpu": audio_check, "two_stage_cfg": two_cfg, "a2vid": a2vid,
                        "two_stage_cfg_and_a2vid_small_input_check": mm_small}}
    seconds = {name: round(t - clock[i][1], 1) for i, (name, t) in enumerate(clock[1:])}
    log(f"chip_smoke: seconds by phase {json.dumps(seconds)} | {smi}")
    log(f"chip_smoke: the whole script took {time.perf_counter() - t_start:.1f} s | {smi}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
