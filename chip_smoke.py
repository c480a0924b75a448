#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``multiverse_torch/csrc`` with nvcc (one process per source, in
   parallel) and prints the build time and ptxas's register report.
2. Kernel phases, at the full width of the beam decode (320 beam rows,
   18x32 grid, D=256, E=32, C=64, the model's decoder weights, permuted
   parents, random ids): K1 (bf16, ``decode_step_gathered``), K2 and K3
   (``decode_step_gathered_q8``, the "int8" and "int8a" tiers, with
   operands from ``quantize_decode_weights``), K7
   (``decode_step_gathered_q8dyn``, "int8_dyn", operands from
   ``quantize_decode_weights_v2``), K8 (``decode_step``) on K1's rows
   gathered by hand and K9 (``decode_step_v2``) on the tables of the
   model's dec_class_emb and dec_class weights; and K6
   (``convlstm_step_fused``) at the training encoder's step (N = 20,
   Cx = 64, D = 256, the model's enc_class weights). Each is held
   against its plain PyTorch version on the card and fails above an
   absolute error of 2e-2 (the tolerance of the JAX package's own
   kernel tests). Times both (medians, CUDA events) and computes each
   kernel's bound from the run's shapes; prints each launch's device
   time (torch.profiler). K1's three launches are also run alone
   (``gate_input_bf16``, ``gate_lstm_bf16``, ``class_readout``): the
   attention's bf16 h2 must equal the plain h2 in at least H2_SAME_MIN
   of entries; the gate launch, fed the plain h2, must give the plain
   gate's bf16 c' in at least K1_C_SAME_MIN of entries, none more than
   one bf16 step of max(|c'|, C_FLOOR) off, a gate that must reject
   three planted layout faults; the readout must agree with the plain
   one within 2e-2. The shares of the launches these replaced
   (``--wmma-shares``) are printed beside the limits. Each launch of K1,
   K2's and K7's attention, K3's attention and the K2/K3 and K7 gate
   launches is timed alone: CUDA events, profiler device time, the
   wrapper's host enqueue time, the bound and the achieved rate; cuDNN's
   bf16 conv2d of K1's gate product is printed as information. K2 and K3
   also fail unless their attention
   launch's int8 gate inputs (h2_q) equal the plain version's but for
   rounding ties (at least 0.9999 of them equal, none more than one step
   off), and unless their gate launch (``gate_lstm_q8``), fed the plain
   h2_q, gives a bf16 c' equal to the plain gate's in at least 0.999 of
   entries with none more than one bf16 step off, a gate that must reject
   three planted layout faults (the last K tile dropped, gates i and g
   swapped in one 8-column chunk, tap 8 zeroed). K3's attention launch,
   the K2/K3 gate launch and K7's gate launch are each timed alone beside
   their own bound and achieved int8 rate, with ``torch._int_mm`` of the
   explicit im2col (the int8 GEMM alone) printed as information. K7 also
   fails unless its h2_f is within 1e-5 of the plain one
   but at pixels (at most 0.001 of them) where every channel's
   difference is explained by whole bf16 steps of the pixel's attention
   weights, unless its r_p is the exact patch max of that h2_f, and
   unless its gate launch, fed the plain h2_f and r_p, gives
   a bf16 c' equal to the plain gate's in at least 0.999 of entries with
   none more than one bf16 step off, a gate that must reject two planted
   faults (the recurrent half at K2's static 127/2; h2_f rounded to
   bf16). K8 must equal K1 within 2e-2, K9 lie within 5e-2 of K8. K6,
   K8 and K9 run on no path: their main-path launches are 0.
3. Offline phases: ``run_multifuture_inference`` as
   ``mvt-torch-multifuture-inference`` runs it, with seeded random
   weights, K=20 diverse beams, T up to 25: bf16 on 32 synthetic
   trajectories (2 batches of 16; pickles written, read back and
   checked; beam-id agreement of batch 0 with the plain version
   printed, which informs and does not gate), then the int8, int8a and
   int8_dyn tiers and int8_dyn greedy on the first 16 (int8_dyn's beam
   ids printed beside int8's; K7 first held against its plain version,
   as in the kernel phase, at the greedy decode's 16 rows with identity
   parents). Each checks that every decode step went through its kernel
   and prints trajectories per second.
4. Serve phases: ``mvt-torch-serve``'s own pieces (its parser and tier
   defaults: bf16 + int8a on cuda) build a beam ``ServingEngine``
   (max_batch 8, T=12) and a greedy one (max_batch 32). For each, K3 is
   first held against its plain version at the rows the engine gives
   it (160 with permuted parents for beam, 32 with identity parents
   for greedy), its gate launch included; then 4 client threads send the
   same requests (32 beam,
   64 greedy) over HTTP on 127.0.0.1 through each front end:
   ``AsyncPredictionServer`` (the CLI's default), then
   ``PredictionServer``. Checks every response, that the int8a kernel
   ran batches x T times, and that one response equals a direct
   forward on the same inputs; prints requests per second, p50 and max
   latency and the batches' padding share (smoke readings: too few
   requests for a tail percentile or a serving knee). Then one burst of
   32 beam requests with ``--compute_dtype bfloat16 --decode_quant
   int8_dyn`` through ``AsyncPredictionServer``, K7 first held against
   its plain version, as in the kernel phase, at the engine's 160 rows.

5. Training-kernel phase: K4 (``gnn_dense_fwd``) and K5
   (``gnn_dense_bwd``) at the training shape (N = 20 samples, 18x32,
   D = 256, C = 64, a unit-normal f32 cotangent) on two operand sets:
   hidden and scene features from the model's own encoders on a
   synthetic batch, and tanh(randn) states with uniform scene features.
   Each output is held against its plain version within 2e-2 x max
   |plain| (max abs error; for K4 also within 2e-2), printed beside max
   and mean |plain|; the same gate must reject planted faults (K4 out =
   0, K5 dnode = 0, dnode without the dedges^T term, dstates = 0) on
   both sets. Kernel, plain and SDPA (the library yardstick, with its
   backend) medians; for K4 and K5 the profiler device time of each
   launch, the events time, the wrapper's host enqueue time a call and
   the share of the bound.
6. Preprocess and training phase: raw files in the reference's format
   (per-video trajectory TSVs at 2.5 fps, a uint8 36x64 scene class map
   per frame, the scene id json; 4 train videos of 5 persons over 39
   frames, one val and one test video) go through
   ``mvt-torch-preprocess``'s own ``main`` with TRAINING.md section 1's
   flags (``--add_grid --add_all_reg --add_scene --direct_scene_feat
   --grid_strides 2,4 --obs_len 8 --pred_len 12``): 400 train, 100 val
   and 100 test examples, the seconds and examples/s printed. Then
   ``mvt-torch-train``'s own ``main`` with the published
   training flags (TRAINING.md, adadelta lr 0.3, soft grid labels, GNN
   and scene encoder, clip 10) plus ``--compute_dtype bfloat16``, batch
   20, 2 epochs of those 400 examples (100 for val), ``--save_period
   20``, on cuda. Checks
   every loss is finite, K4 and K5 ran steps x 12 times, the evals' K1
   ran batches x 12 times, the last 10 steps' mean loss is below the
   first step's, both checkpoint directories hold the port's orbax
   steps and the best one decodes a batch through ``run_multifuture_inference``. Then one
   train step through the kernels and one through the plain versions on
   the same weights and batch (loss within 1e-2 relative, every
   gradient within 2e-2 relative L2); prints buffered steps/s and
   examples/s, the device idle share over 5 steps and the top device
   operations of one step.
7. SimAug phase: the training-kernel phase (5.) again at SimAug's
   shapes, N = 36 (the multiview attack, batch 12 x 3 views) and N = 12
   (its outer step), gates and planted faults included (run right after
   phase 5, before any step is profiled); one multiview
   attack step (``_attack_step_with_loss`` and the input gradient it
   signs) at 36 rows through K4/K5 and through their plain versions on
   the same weights, batch and draws at keep_prob 1 (per-example CE
   within 1e-2 relative, the input gradient within 2e-2 relative L2,
   the share of stepped features that differ printed);
   ``mvt-torch-train-simaug``'s own ``main`` with TRAINING.md section
   2's published flags plus ``--compute_dtype bfloat16`` (keep_prob
   0.7), one epoch of synthetic 4-camera data (60 agents x 4 cameras,
   48 val examples; ``synthesize_multiview_prepro``), an eval/save every
   10 steps, on cuda: every loss finite, K4 and K5 each ran steps x 12
   x 2 times (the attack's tower pass and the outer one), the evals' K1
   evals x val batches x 12 times, both checkpoint directories hold the
   port's orbax steps and the best one decodes a batch through
   ``run_multifuture_inference``. Then one outer step on one augmented
   batch through K4/K5 and through their plain versions (loss within
   1e-2, every gradient within 2e-2 relative L2); the multiview step's
   buffered steps/s and examples/s, idle share and top device
   operations; and the ``--adv_train`` PGD-30 step at batch 12: seconds
   a step over 3 steps, K4 and K5 each 31 x 12 launches a step.
8. Serve-lifecycle phase, on phase 6's run directory:
   ``mvt-torch-serve``'s own ``main`` loads the latest ``save`` step (no
   --load_from, no --random_init) in its cuda tier (bf16 + int8a, beam
   max_batch 8, K = 20) with ``--reload_poll_s 0.2`` and serves through
   ``AsyncPredictionServer``. K3 is first held against its plain version
   at the engine's 160 rows on the served weights, then 32 requests from
   4 client threads (checked as in 4.). Then 5 more train steps on that
   step (K4/K5 counted) are saved by ``CheckpointManager.save`` as the
   next step, an orbax step directory with the port's mark (phase 13
   (b)); requests are sent until the responses follow the new
   weights, and the seconds from the step's rename to that response are
   printed. That response must equal a direct forward on the new step's
   weights (loaded from its file) within 1e-3 and differ from the old
   step's by more than 1e-3 in its beam log-probs; then another 32
   requests. Last, ``run_multifuture_inference`` of the reloaded step,
   loaded as ``mvt-torch-multifuture-inference`` loads its
   ``model_path``, in int8a on 32 trajectories (K3 batches x T times,
   pickles checked), and a second run with ``timings``: traj/s and the
   build, fetch and pack seconds.

9. Multi-device phase, on phase 6's data and phase 8's run directory
   (``multiverse_torch.parallel``; two ranks on one card time-share it,
   so nothing here is a scaling figure). Two ``gloo`` ranks on cuda:0
   (NCCL refuses two ranks on one device), spawned by ``launch``, each
   with its block of the train batch (10 of 20): the sharded train step
   (``sharded_loss_and_grads``) at the published configuration in bf16
   on the newest saved step, its averaged loss within 1e-2 and every
   averaged gradient within 2e-2 relative L2 of the single-process
   step's on the same batch and weights, the updated parameters and the
   update itself each within 2e-2 relative L2, K4/K5 12 launches a rank
   a step, two all-reduces a step; 15 timed steps (steps/s, each
   rank's profiler busy time, the card's idle share). The sharded beam
   decode (bf16, K1) of 16 trajectories of the trained run: beam ids
   agree with the single-process decode's in at least DP_BEAM_SAME_MIN
   of beams, the log-probs of those within 5e-3, K1 12 launches a
   rank. A
   ``ServingEngine`` over the two ranks (bf16 + int8a, max_batch 8,
   K = 20) on the next-newest step: 32 requests submitted together
   (a batch of more than 4 fills rank 1's rows) equal to the 1-rank
   engine's answers within 1e-3 (p50 latency of both printed), then
   ``update_params`` with the newest step and again, now unlike the old
   weights' answers; K3 the same count on both ranks. Then
   ``mvt-torch-train``'s own ``main`` for one epoch (20 steps) over
   every visible GPU (``make_mesh_for_batch``, nccl; world 1 on one
   card, in this process with no group and no collective, its K4/K5/K1
   launches counted), and in an NCCL group over those GPUs (of one, on
   one card) the sharded step's and the single-process step's buffered
   steps/s and idle share, alternated twice: the cost of the group.
10. JAX-checkpoint phase: the orbax run directory committed under
   ``tests/torch_fixtures/jax_run`` (written by the JAX package's own
   ``CheckpointManager``, ``tests/make_jax_fixture.py``) at the
   published widths with both grid scales (21,337,728 parameters;
   leaves drawn from seeded codebooks so the step takes 3.7 MB, remade
   here by ``fixture_leaf``), read on this machine, which has no orbax,
   tensorstore or zstandard (and the port imports no JAX).
   The zstd decoder is built (g++; seconds printed); the step is read
   through ``read_checkpoint_tree`` and must equal the leaves made from
   the seed at tolerance 0 (host seconds and MB/s printed); the frame
   of a leaf of plain random weights is decoded alone (MB/s printed, and
   the seconds a published-width checkpoint of such frames would take
   at that rate); ``load_checkpoint`` at ``use_grids 1,0`` must equal
   those leaves pruned. ``mvt-torch-serve``'s own ``main`` then serves a
   copy of that run directory from the directory (no --load_from) in
   its cuda tier (bf16 + int8a, beam max_batch 8, K = 20) at the
   published widths: K3 held against its plain version at the engine's
   160 rows, 8 requests from 4 threads (checked as in 4.), and one
   response within 1e-3 of a direct forward on the seed's weights.
   Last, ``run_multifuture_inference`` with the copy's ``save``
   directory as its ``model_path``, in bf16 (K1), on 16 trajectories,
   checked as in 3. Its K1 and K3 launches are added to the paths'.
11. Tensor-parallel phase (``multiverse_torch/parallel/tensor.py``), on
   phase 6's newest step and TP_EXAMPLES generated examples: (a) two
   gloo ranks on cuda:0 at dp 1 x mp 2 (``make_mesh(devices=["cuda:0"]
   * 2, model_parallel=2)``), each holding its block of every sharded
   weight and the optimizer slots made from it, train TP_STEPS steps on
   one batch of 20 (the published bf16 configuration, K4/K5 on every
   model rank); the ranks' losses must be equal, within DP_UPDATE_RTOL
   of the single process's on the same weights and batch, and the
   gathered whole weights and their update within DP_UPDATE_RTOL
   (relative L2) of the single process's; then one step on the dp 2 x
   mp 2 grid of four ranks on the card, held the same way; (b) each
   rank's bytes of weights and slots beside the single process's, and
   the share of leaves sharded; (c) steps/s, each rank's device busy
   time a step, the card's idle share, and the model group's
   all-reduces and their bytes in one step; (d) K4/K5 TP_STEPS x 12 a
   rank and K1 12 a rank in one sharded eval of the gathered weights;
   (e) ``mvt-torch-train``'s rank worker with ``--model_parallel 2`` on
   those two ranks (``--load_from`` the same step, TP_STEPS epochs of
   the 20 examples, a save at the end): its saved step must equal the
   whole weights it gathered at tolerance 0 and (a)'s within
   DP_UPDATE_RTOL, and ``mvt-torch-test`` evaluates it in one process
   on the card (K1).
12. Data-preparation phase (``multiverse_torch/cli/prepare_data.py``,
   host numpy), in phase 6's temporary directory after phase 11, with
   no jax. (a) The Forking Paths benchmark at
   its published widths (VIRAT scene 0000, 30 fps, 1920x1080): bbox
   JSONs in the recorder's format for 4 moments x 2 cameras x 5
   annotated futures (40 videos, 8 obs keys) and 8 anchor videos of 4
   persons, and a 36x64 scene class map per needed frame (written here:
   no recorder renders seg MP4s; (c) decodes some), through the commands'
   own mains: ``mvt-torch-split-path``, ``-prepare-multifuture`` (0
   skipped, 8 obs, every file of the JAX layout, each GT pickle 5
   futures of 12 steps), ``-prepare-anchor``, ``-preprocess`` with
   TRAINING.md section 1's flags, ``mvt-torch-train`` for one epoch at
   the published configuration in bf16 (K4/K5 steps x 12, eval K1 val
   batches x 12, a save at the end), ``mvt-torch-multifuture-inference``
   of that run's newest step on the 8 prepared obs in bf16 (K1) and
   int8a (K3), K = 20 (each kernel batches x T times), and
   ``mvt-torch-eval-trajs`` and ``-eval-prob`` on both outputs (every
   number finite; the numbers are information after one epoch). (b)
   ``mvt-torch-prepare-sdd`` (4 SDD videos of 10,000 annotation lines,
   one rotated), ``-sdd-splits``, ``-prepare-argoverse`` (2 logs of 300
   label files of 40 cuboids), ``-combine-traj`` with and without
   ``--is_actev`` on (a)'s anchor TSVs, and ``-gen-moments``, each timed
   (host seconds and rows/s beside the card's name and power limit) and
   checked for its outputs. (c) Where cv2 or yaml cannot be imported,
   ``mvt-torch-sdd-frames``, ``-resize-rotate-sdd``,
   ``-extract-frames-seg`` and ``-get-vehicle-traj`` must stop with an
   ImportError naming the package and the command, having written
   nothing; where one can, its commands run on small generated inputs
   and their outputs are checked. Phase 12's K1, K3, K4 and K5 launches
   are added to the paths'.
13. Checkpoint-writing phase (``train/orbax_writer.py`` over
   ``train/ocdbt.py``'s writer; ``tools/tf_bundle.py``,
   ``tools/tf_converter.py``, ``cli/convert_tf.py``), with no jax, orbax,
   tensorstore or tensorflow. (a) The published model with both grid
   scales (FIXTURE_GRIDS, 21,337,728 parameters of seeded random
   weights) is saved by ``CheckpointManager.save`` as an orbax step and
   read back by ``read_checkpoint_tree``: every leaf equal at tolerance
   0; the write's and the read's host seconds and MB/s printed beside
   the card's name and power limit. 16 trajectories are decoded (K = 20
   diverse beams, ``beam_forward``) in bf16 (K1) and in int8a (K3) from
   the weights read back and from the same weights before the write:
   beam ids and log-probs equal bit for bit. (b) Phase 8's hot reload
   followed a step the port wrote in this layout (checked there). (c)
   The committed TF bundle ``tests/torch_fixtures/tf_ckpt`` (reference
   names, Adadelta slots, global_step; ``tests/make_tf_fixture.py``) is
   converted by ``mvt-torch-convert-tf``'s own ``main`` into a run
   directory: every leaf of its ``save`` and ``best`` steps equal to the
   leaves remade from the fixture's seed at tolerance 0; then
   ``mvt-torch-test`` with ``--load_best`` in bf16 on a generated test
   split (K1), and the best step, loaded as
   ``mvt-torch-multifuture-inference`` loads it, decodes 16 trajectories
   in int8a through K3, checked as in 3. Its K1 and K3 launches are
   added to the paths'.
14. Plotting phase (``multiverse_torch/vis``, the ``mvt-torch-vis-*``
   and CARLA-conversion commands; host numpy, cv2 and scipy), in phase
   12's temporary directory after it, on its files at the published
   1920x1080 frame size. (a) A PLOT_FRAMES-frame mp4v video of each of
   its 8 obs keys, then ``mvt-torch-vis-multifuture`` on its bf16 (K1)
   and int8a (K3) ``.traj.p``, without --use_heatmap for every key and
   with it for every PLOT_HEATMAP_JOB-th (--job/--curJob), and
   ``mvt-torch-vis-dataset`` on the same videos and GT pickles: every
   drawn key has its directory and frames, and every jpg differs from
   the jpg of the video frame it was drawn on. (b) ``mvt-torch-test
   --save_output`` on phase 12's trained run, greedy and with K = 20
   diverse beams (K1 batches x T for the eval, as many again for the
   beam decode, checked), then ``mvt-torch-vis-grid`` on each pickle
   (class heatmaps; beam paths) over PLOT_GRID_FRAMES generated frames
   of the test video, and ``mvt-torch-vis-output`` on both pickles as
   two coloured runs, --ordered and with --use_heatmap. (c)
   ``mvt-torch-vis-real-data`` (with and without --h_file),
   ``mvt-torch-vis-sdd-annotation`` on the prepared SDD files,
   ``mvt-torch-plot-traj-carla --save_carla_traj_file`` (with and
   without --is_actev) and ``mvt-torch-batch-plot-traj-carla`` (ActEV,
   one scene-0002 file skipped, and ETH/UCY) on the world TSVs; each
   command's printed line and files are checked. Each command prints
   its host seconds and frames (or rows) a second beside the card's
   name and power limit; cv2 and scipy must import. Its K1 launches are
   added to the paths'.
15. Recorded-moment phase (``multiverse_torch/forking_paths``'s
   recorder, moment and pygame tools, ``cli/moment_tools.py``,
   ``data/scene_extract.py``), last, in a temporary directory of its
   own: the Forking Paths chain from a moment recorded through the fake
   CARLA backend (``tests/torch_fake_carla.py``) to K = 20 scores. (1)
   ``mvt-torch-record-moments``'s own ``main``, one process a recording,
   all at once: REC_OBS_KEYS x REC_FUTURES moments built
   with ``traj_to_controls`` (an x-agent and a second pedestrian,
   REC_FRAMES frames at 25 fps: obs 8 + pred 12 at 2.5 fps) seen by a
   straight-down 1920x1080 rig from a registry in the temporary
   directory, and one ``--is_anchor_moment`` recording from the packaged
   registry's anchor rig; every recording's rgb and seg mp4 and bbox
   JSON checked (both walkers boxed). ``mvt-torch-build-moment`` replays
   the first walk (``replay OK``) and ``mvt-torch-auto-moment-candidates``
   sweeps it (candidates found). (2) ``extract_frames_and_seg`` to the
   published 36x64 class maps (every map decodes to ADE20k person),
   ``prepare_multifuture_split`` (2 obs keys x 2 futures of 12 steps),
   ``prepare_anchor_split`` and ``mvt-torch-preprocess``'s ``main``
   with TRAINING.md's flags. (3) ``mvt-torch-train``'s ``main`` at the
   published flags in bf16 on cuda for 2 epochs (every loss finite; K4
   and K5 steps x 12; the eval's K1 batches x 12), then
   ``mvt-torch-multifuture-inference`` at K = 20 in bf16 (K1) and int8a
   (K3) on the 2 recorded obs keys (each kernel batches x T times), and
   ``mvt-torch-eval-trajs`` and ``-eval-prob`` (finite scores). (4)
   ``segment_images`` of ``mvt-torch-extract-scene-seg`` over every
   REC_SEG_EVERY-th recorded RGB frame with a fixed numpy segmenter
   (every npy checked).
   In subprocesses: where tensorflow imports, ``mvt-torch-extract-
   scene-seg`` on a one-op DeepLab graph (the card hidden); where
   pygame imports, ``mvt-torch-spectator`` and the moment editor at
   1920x1080 under SDL's dummy driver; where transformers imports, the
   command with a random SegFormer built from a small ``SegformerConfig``
   on cuda and on cpu (seconds a frame each; the share of equal pixels
   printed as information). Where one of the three, or a package it
   needs (SegFormer's image processor needs torchvision from
   transformers 5), does not import, a line says what was not run and
   why; a failure of a part that ran fails the phase. (5) Each stage prints its host seconds and frames/s
   or examples/s beside the card's name and power limit, and the phase
   its total. Its K1, K3, K4 and K5 launches are added to the paths'.
16. Convergence-campaign phase (``multiverse_torch/campaign``), last, in
   a temporary directory of its own: both campaigns at the published
   flags (full width, bf16, on cuda), cut only in data and epochs
   (CAMP_FLAGSHIP, CAMP_SIMAUG). The flagship's stages through its
   ``main``: data (moments recorded through ``tests/torch_fake_carla.py``
   at 192x108, extracted, prepared, preprocessed), run A, run B
   SIGKILLed at the first save of epoch CAMP_EPOCHS // 2 and resumed
   with ``--load``, the f32 and int8a K = 20 decodes of A's best with
   both evaluators, and the artifact; then SimAug's data, train and
   artifact. Every command a stage starts runs as ``chip_smoke.py
   --counted`` (below), so each reports its kernels' launches. Checks
   that every command exits 0, that each train command launched K4 and
   K5 12 times a step and grid scale (twice that a SimAug step) and K1
   in its evals, that the int8a decode launched K3 batches x T times and
   the f32 decode no kernel, that run A's final val ADE is below its
   first eval's, that run B's evals after its loaded baseline (at the
   kill step) and its last save lie above the kill step, and that every
   score is finite; prints the convergence fields, the resume check,
   each command's launches, each stage's seconds, and the int8a decode's
   beam ids against the f32 one on A's best (``tier_agreement``, which
   informs and does not gate). Its K1, K3, K4 and K5 launches are added
   to the paths'.

Prints one JSON line describing the kernels, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero;
without CUDA it exits nonzero before printing anything.

    python3 chip_smoke.py --wmma-shares <checkout>

measures only the K1 shares of another checkout's library through the C
interface it had before the wgmma bf16 gate launch (commit 44284ee), the
numbers behind WMMA_H2_SAME and WMMA_C_SAME.

    python3 chip_smoke.py --gnn-only

builds the kernels and runs only the training-kernel phase (5.), with
its gates; copied into another checkout, it reads that checkout's K4
and K5 the same way.

    python3 chip_smoke.py --recorded-only

builds the kernels and runs only the recorded-moment phase (15.).

    python3 chip_smoke.py --campaign-only

builds the kernels and runs only the convergence-campaign phase (16.).

    python3 chip_smoke.py --tier-agreement <flagship work directory>

prints ``tier_agreement`` of a flagship campaign's run A (the full
campaign's ``_campaign_torch/``).

    python3 chip_smoke.py --counted <file> <module> <args>

runs ``module``'s ``main(args)`` and appends its kernels' launches to
``file`` (the form phase 16's commands take).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from multiverse_torch import inference
from multiverse_torch.cli import multifuture_eval_trajs as eval_trajs_cli
from multiverse_torch.cli import multifuture_eval_trajs_prob as eval_prob_cli
from multiverse_torch.cli import multifuture_inference as inference_cli
from multiverse_torch.cli import prepare_data as prepare_cli
from multiverse_torch.cli import preprocess as preprocess_cli
from multiverse_torch.cli import serve
from multiverse_torch.cli import train as train_cli
from multiverse_torch.cli import test as test_cli
from multiverse_torch.cli import train_simaug as simaug_cli
from multiverse_torch.cli import vis_annotation as vis_annotation_cli
from multiverse_torch.cli import vis_dataset as vis_dataset_cli
from multiverse_torch.cli import vis_multifuture_trajs_video as vis_mf_cli
from multiverse_torch.cli import vis_real_data as vis_real_cli
from multiverse_torch.cli import visualize_grid as vis_grid_cli
from multiverse_torch.cli import visualize_output as vis_output_cli
from multiverse_torch.config import MultiverseConfig
from multiverse_torch import parallel
from multiverse_torch.campaign import flagship as camp_flagship
from multiverse_torch.campaign import simaug as camp_simaug
from multiverse_torch.bridge import (
    params_from_jax,
    params_to_numpy_tree,
    prune_to_template,
)
from multiverse_torch.data.dataset import (
    batch_to_device,
    read_data,
    synthesize_prepro,
)
from multiverse_torch.data.multiview import (
    MultiviewDataset,
    synthesize_multiview_prepro,
)
from multiverse_torch.forking_paths import controls as fp_controls
from multiverse_torch.forking_paths import moments as fp_moments
from multiverse_torch.forking_paths import prepared_data
from multiverse_torch.geometry import one_hot_grid
from multiverse_torch.models import Multiverse, simaug
from multiverse_torch.native import zstd
from multiverse_torch.models.simaug import SimAugConfig
from multiverse_torch.ops import (
    ConvLSTMState,
    _build,
    conv2d,
    convlstm_step,
    get_activation,
)
from multiverse_torch.ops.fused_cell import (
    convlstm_step_fused,
    convlstm_step_fused_ref,
)
from multiverse_torch.ops.fused_decode import (
    build_emb_gates_tables,
    class_readout,
    class_readout_ref,
    decode_step,
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_q8dyn,
    decode_step_gathered_q8dyn_ref,
    decode_step_gathered_ref,
    decode_step_ref,
    decode_step_v2,
    decode_step_v2_ref,
    _im2col9,
    gate_input_bf16,
    gate_input_bf16_ref,
    gate_input_q8,
    gate_input_q8_ref,
    gate_inputs_q8dyn,
    gate_inputs_q8dyn_ref,
    gate_lstm_bf16,
    gate_lstm_bf16_ref,
    gate_lstm_q8,
    gate_lstm_q8_ref,
    gate_lstm_q8dyn,
    gate_lstm_q8dyn_ref,
    h2f_weight_flips,
    row_scales_q8dyn_ref,
)
from multiverse_torch.ops import fused_gnn
from multiverse_torch.ops import quant as quant_ops
from multiverse_torch.ops.fused_decode import _neighbor_bias
from multiverse_torch.ops.gate_layout import prepare_gate_weights
from multiverse_torch.ops.fused_gnn import (
    gnn_dense_bwd,
    gnn_dense_bwd_ref,
    gnn_dense_fwd,
    gnn_dense_fwd_ref,
    normalised_node,
)
from multiverse_torch.ops.quant import (
    quantize_decode_weights,
    quantize_decode_weights_v2,
)
from multiverse_torch.serving.aserver import AsyncPredictionServer
from multiverse_torch.serving.client import PredictionClient
from multiverse_torch.serving.engine import (
    RawInputs,
    ServingEngine,
    rasterize_batch,
)
from multiverse_torch.serving.server import PredictionServer
from multiverse_torch.train import trainer
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    list_steps,
    load_checkpoint,
    read_checkpoint_tree,
)
from multiverse_torch.train.ocdbt import OcdbtReader
from multiverse_torch.train.orbax_reader import is_orbax_step, orbax_steps
from multiverse_torch.train.orbax_writer import written_by_port

TOL = 2e-2
# least share of the q8 kernels' int8 gate inputs (h2_q) equal to the
# plain version's: only rounding ties may differ. A gate input
# requantised from a bf16 copy of h + agg, or int8a attention left in
# bf16, would stay within TOL on h, c and logits but miss this
H2Q_SAME_MIN = 0.9999
# K7's gate inputs: h2_f within H2F_ATOL of the plain version's but at
# pixels where the attention launch, summing an edge in another order,
# rounded one or more of the pixel's attention weights to the next bf16
# value: each such pixel's difference must be explained so, channel by
# channel (``h2f_weight_flips``), and they may be at most FLIPPED_MAX of
# the pixels (a rounding that is wrong everywhere would move thousands).
# r_p must be the exact patch max of the launch's own h2_f (max is exact)
H2F_ATOL, FLIPPED_MAX = 1e-5, 1e-3
# K7's gate launch on the plain version's own h2_f and r_p: bf16 c' equal
# to the plain gate's in at least this share, none more than one step off
C_SAME_MIN = 0.999
# K1's launches alone. The shares of the wmma-era launches (the C
# interface before the wgmma bf16 gate launch and the staged attention,
# commit 44284ee) at this phase's 320 rows, measured with
# ``python3 chip_smoke.py --wmma-shares <checkout of 44284ee>`` on an
# NVIDIA H100 80GB HBM3 at 700 W: its attention's bf16 h2 equal to the
# plain h2, and its gate launch's c' (fed the plain h2) equal to the plain
# gate's. The limits: no lower than those, nor than C_SAME_MIN for c'
WMMA_H2_SAME, WMMA_C_SAME = 0.999971, 0.999460
H2_SAME_MIN = 0.9999
K1_C_SAME_MIN = C_SAME_MIN
# K1's c' steps are counted at max(|c'|, C_FLOOR): one step there, 2^-13,
# is ten times the f32 sum-order noise of its gates (K = 2592), while a
# layout fault moves c' by tenths
C_FLOOR = 2.0 ** -6
# one H100 SXM at 700 W: dense tensor-core peaks and HBM rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12
KERNELS = {
    "K1": {"name": "decode_step_gathered (bf16)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:430"},
    "K2": {"name": "decode_step_gathered_q8 (int8)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode_q8.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:885"},
    "K3": {"name": "decode_step_gathered_q8 (int8a)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode_q8.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:974"},
    "K4": {"name": "gnn_dense_fwd (GnnDense forward)", "route": "cuda",
           "source": "multiverse_torch/csrc/gnn_dense.cu",
           "replaces": "multiverse_tpu/ops/pallas_gnn.py:106"},
    "K5": {"name": "gnn_dense_bwd (GnnDense backward)", "route": "cuda",
           "source": "multiverse_torch/csrc/gnn_dense.cu",
           "replaces": "multiverse_tpu/ops/pallas_gnn.py:123"},
    "K6": {"name": "convlstm_step_fused (ConvLSTM cell)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode.cu",
           "replaces": "multiverse_tpu/ops/pallas_cell.py:66"},
    "K7": {"name": "decode_step_gathered_q8dyn (int8_dyn)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode_q8.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:760"},
    "K8": {"name": "decode_step (no gather)", "route": "cuda",
           "source": "multiverse_torch/csrc/fused_decode.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:527"},
    "K9": {"name": "decode_step_v2 (embedding gates from tables)",
           "route": "cuda", "source": "multiverse_torch/csrc/fused_decode.cu",
           "replaces": "multiverse_tpu/ops/pallas_decode.py:322"},
}

# TRAINING.md's published training command (its --grid_strides is
# --scene_grid_strides in both trainers) plus bf16, at batch 20, 2
# epochs and an eval/save every 20 steps
TRAIN_FLAGS = ["--batch_size", "20", "--num_epochs", "2", "--init_lr", "0.3",
               "--optimizer", "adadelta", "--use_gnn", "--use_scene_enc",
               "--use_soft_grid_class", "--soft_grid", "1",
               "--scene_grid_strides", "2,4", "--use_grids", "1,0",
               "--grid_loss_weight", "1.0", "--grid_reg_loss_weight", "0.1",
               "--wd", "0.0001", "--save_period", "20",
               "--compute_dtype", "bfloat16", "--device", "cuda"]
TRAIN_EXAMPLES, VAL_EXAMPLES = 400, 100
# TRAINING.md section 1's mvt-preprocess flags (the paths are added)
PREPRO_FLAGS = ["--add_grid", "--add_all_reg", "--add_scene",
                "--direct_scene_feat", "--grid_strides", "2,4",
                "--obs_len", "8", "--pred_len", "12"]
# the raw files phase 6 writes in the reference's format: RAW_VIDEOS
# videos a split, each with RAW_PERSONS persons seen in all RAW_FRAMES
# frames (2.5 fps), so (RAW_FRAMES - 19) x RAW_PERSONS examples a video:
# TRAIN_EXAMPLES, VAL_EXAMPLES and 100 test examples
RAW_VIDEOS = {"train": 4, "val": 1, "test": 1}
RAW_PERSONS, RAW_FRAMES = 5, 39
# the serve-lifecycle phase: the reload poll period, and the train steps
# between the served step and the one that replaces it
RELOAD_POLL_S, RELOAD_STEPS = 0.2, 5
# TRAINING.md section 2's published SimAug command (its --grid_strides is
# --scene_grid_strides in both trainers) plus bf16, keep_prob at the
# command's 0.7, one epoch of synthetic 4-camera data (SIMAUG_AGENTS
# agents x 4 cameras; SIMAUG_VAL val examples) and an eval/save every
# SIMAUG_SAVE_PERIOD steps
SIMAUG_AGENTS, SIMAUG_VAL, SIMAUG_SAVE_PERIOD = 60, 48, 10
SIMAUG_FLAGS = ["--batch_size", "12", "--num_epochs", "1", "--init_lr", "0.3",
                "--multiview_train", "--multiview_exp", "3",
                "--adv_use_fgsm", "--use_mixup", "--mixup_alpha", "1.0",
                "--adv_epsilon", "0.1", "--double_weighting",
                "--fl_gamma", "1.0", "--use_gnn", "--use_scene_enc",
                "--scene_grid_strides", "2,4", "--use_grids", "1,0",
                "--compute_dtype", "bfloat16",
                "--save_period", str(SIMAUG_SAVE_PERIOD), "--device", "cuda"]
# TRAINING.md section 2's PGD mode at the same batch and widths
PGD_FLAGS = ["--batch_size", "12", "--init_lr", "0.3", "--adv_train",
             "--adv_num_iter", "30", "--adv_step_size", "0.001",
             "--use_gnn", "--use_scene_enc", "--scene_grid_strides", "2,4",
             "--use_grids", "1,0", "--compute_dtype", "bfloat16"]
# the README quick-start beam flags at the published widths
QUICKSTART_FLAGS = ["--use_gnn", "--use_scene_enc", "--use_beam_search",
                    "--beam_size", "20", "--diverse_beam",
                    "--diverse_gamma", "0.01", "--fix_num_timestep", "1"]


# phase 10's run directory of the JAX package (tests/make_jax_fixture.py):
# the published widths with both grid scales (21,337,728 parameters,
# 85.35 MB of f32). Its leaves are made by fixture_leaf, not stored
# beside it: a leaf of more than FIXTURE_PLAIN_MAX values is blocks of
# FIXTURE_BLOCK values drawn from a codebook of FIXTURE_BOOK such blocks,
# whose zstd frames (FSE-coded sequences over a Huffman-coded codebook)
# take 3.4 MB where random weights take 79 MB; a smaller leaf is plain
# random weights, as a trained checkpoint's frames are (Huffman-coded
# literals, hardly any matches)
JAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_fixtures", "jax_run")
FIXTURE_GRIDS = (True, True)
FIXTURE_SEED, FIXTURE_BLOCK, FIXTURE_BOOK = 11, 16, 256
FIXTURE_PLAIN_MAX = 1 << 16
# the plain-weights leaf whose frame phase 10 times alone
FIXTURE_PLAIN_LEAF = "scene_conv2/w"


def fixture_leaf(name: str, shape) -> np.ndarray:
    """The committed JAX fixture's leaf ``name`` (``scales/0/dec_class/
    kernel``) of ``shape``, made from the seed and the name alone (the
    legacy ``RandomState``, whose streams numpy keeps fixed), here and
    by ``tests/make_jax_fixture.py`` that wrote it."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    rng = np.random.RandomState(
        (FIXTURE_SEED * 7919 + zlib.crc32(name.encode())) % (1 << 32))
    std = 1 / np.sqrt(np.prod(shape[:-1])) if len(shape) > 1 else 0.1
    if n <= FIXTURE_PLAIN_MAX:
        return (rng.standard_normal(shape) * std).astype(np.float32)
    book = (rng.standard_normal((FIXTURE_BOOK, FIXTURE_BLOCK)) * std) \
        .astype(np.float32)
    pick = rng.randint(0, FIXTURE_BOOK, -(-n // FIXTURE_BLOCK))
    return book[pick].reshape(-1)[:n].reshape(shape)


def fixture_tree(template: Multiverse) -> dict:
    """The fixture's leaves of ``template``'s names and shapes, as the
    nested dict ``read_checkpoint_tree`` returns."""
    tree: dict = {}
    for name, p in template.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = fixture_leaf("/".join(parents + [leaf]), p.shape)
    return tree


def flagship_config(**kw) -> MultiverseConfig:
    """The README quick-start beam configuration: K=20 diverse beam,
    gamma 0.01, fix_num_timestep 1, GNN and scene encoder on, bf16,
    18x32 grid, D=256, E=32, scene_conv_dim 64."""
    return MultiverseConfig(
        use_gnn=True, use_scene_enc=True, use_beam_search=True,
        beam_size=20, diverse_beam=True, diverse_gamma=0.01,
        fix_num_timestep=1, compute_dtype="bfloat16",
        beam_select="twostage", **kw).validate()


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- kernels


def kernel_operands(model: Multiverse, cfg: MultiverseConfig, dev,
                    NK: int, identity: bool = False):
    """Full-width operands of NK decode rows in the layouts the decoders
    pass: the model's decoder weights, random tanh-range state, parents
    permuted (beam) or identity (greedy); and the int8 operands of
    those weights."""
    H, W = cfg.scene_grids[0]
    HW, D = H * W, cfg.dec_hidden_size
    bf = torch.bfloat16
    sp = model["scales"]["0"]
    g = torch.Generator().manual_seed(1)
    basis = torch.eye(HW, device=dev).reshape(HW, H, W, 1)
    emb = conv2d(sp["dec_class_emb"], basis,
                 activation=get_activation(cfg.activation), compute_dtype=bf)
    ops = dict(
        cell_w=sp["dec_class"]["kernel"].to(bf).reshape(-1, 4 * D),
        cell_b=sp["dec_class"]["bias"].float(),
        h2g_w=sp["h2g_class"]["w"].to(bf).reshape(9, D).t(),
        prev_ids=torch.randint(0, HW, (NK,), generator=g, dtype=torch.int32),
        parent_rows=(torch.arange(NK) if identity
                     else torch.randperm(NK, generator=g)).to(torch.int32),
        emb_table=emb.to(bf).reshape(HW, HW, -1),
        h=(torch.rand(NK * HW, D, generator=g) * 2 - 1).to(bf),
        c=torch.randn(NK * HW, D, generator=g).to(bf),
        scene=torch.rand(NK * HW, cfg.scene_conv_dim, generator=g).to(bf),
    )
    ops = {k: v.to(dev).contiguous() for k, v in ops.items()}
    quant = quantize_decode_weights(sp["dec_class"], emb)
    return ops, quant, H, W


def roofline(nbytes: float, ops: dict) -> dict:
    """Least time for work that moves ``nbytes`` and does ``ops``
    (operations by type): the larger of the bytes over the HBM rate and
    the operations over the tensor-core peak of their type."""
    ops_s = sum(n / PEAK_OPS[t] for t, n in ops.items())
    bytes_s = nbytes / HBM_BYTES_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def bound(ops, H, W, E, gate_type: str, attn_type: str,
          emb: str = "table", n_scales: int = 1) -> dict:
    """Least time for one decode step on these inputs: each input read
    once, each output written once (h, c, scene; h', c', logits), and the
    gate product, the nine-neighbour attention (edges and aggregation)
    and the readout. ``emb`` says what the embedding half reads:
    "table", the table rows these ids need and a gate product over
    9(E + D) (K1, K2, K3, K7, with ``n_scales`` f32 scale vectors beside
    the bias); "rows", one row per state row (K8); "tables", the
    background map and the 5x5 slabs these ids need, the product over 9D
    only (K9)."""
    NK = ops["prev_ids"].shape[0]
    D = ops["h"].shape[-1]
    C = ops["scene"].shape[-1]
    HW, M = H * W, NK * H * W
    w_bytes = 1 if gate_type == "int8" else 2
    n_ids = int(torch.unique(ops["prev_ids"]).numel())
    gate_k = 9 * D if emb == "tables" else 9 * (E + D)
    emb_bytes = {"table": n_ids * HW * E * w_bytes + NK * 8,   # + ids, parents
                 "rows": M * E * 2,
                 "tables": (HW + n_ids * 25) * 4 * D * 2 + NK * 4}[emb]
    nbytes = (2 * M * D * 2 + M * C * 2 + emb_bytes
              + gate_k * 4 * D * w_bytes + 4 * D * 4 * n_scales   # w, b
              + D * 9 * 2                                  # readout w
              + 2 * M * D * 2 + M * 4)                     # h', c', logits
    work = {"bf16": 2.0 * M * 9 * D, "int8": 0.0}          # readout
    work[gate_type] += 2.0 * M * gate_k * 4 * D
    work[attn_type] += 2.0 * M * 9 * ((D + C) + D)
    return roofline(nbytes, work)


def launch_breakdown(what: str, fn, reps: int = 5) -> dict:
    """Prints the mean device time of each CUDA kernel one call of
    ``fn`` launches (torch.profiler over ``reps`` calls) and returns
    them, ms by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", 0)
        if us > 0 and evt.count >= reps:
            # "void (anonymous namespace)::gate_lstm_kernel<...>(...)": the
            # template arguments tell apart the launches of one template
            found = re.search(r"(\w+(?:<[^>]*>)?)\(", evt.key)
            name = found.group(1) if found else evt.key
            launches[name] = launches.get(name, 0.0) + us / reps / 1e3
            print("kernel phase %s: launch %s %.4f ms (%d per call)"
                  % (what, name, launches[name], evt.count // reps))
    return launches


def host_enqueue_ms(fn, calls: int = 30) -> float:
    """The wrapper's host time a call: ``calls`` calls enqueued with no
    sync between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host_ms


def check_close(what: str, out, ref) -> float:
    errs = {name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("h", "c", "logits"), out, ref)}
    print(f"kernel phase {what}: max abs err vs plain:", errs)
    for name, err in errs.items():
        if not err <= TOL:
            raise AssertionError(
                f"{what} disagrees with the plain version on {name}: "
                f"max abs err {err} > {TOL}")
    return max(errs.values())


def check_q8(what: str, quant, q8: dict, H: int, W: int, attn_q8: bool):
    """K2 (int8) or K3 (int8a) against its plain version on the same
    card tensors: h, c and logits within TOL, the int8 gate inputs
    (h2_q) of the attention launch equal to the plain version's but for
    rounding ties, which move an entry by one step, and the gate launch
    on the plain version's own h2_q giving the plain gate's c' but for
    rounding (``c_gate``). Returns the step (to time), its max abs err
    and the plain h2_q."""
    def run(fn=decode_step_gathered_q8):
        return fn(quant, **q8, H=H, W=W, attn_q8=attn_q8)
    out = run()
    torch.cuda.synchronize()
    err = check_close(what, out, run(decode_step_gathered_q8_ref))
    args = (q8["parent_rows"], q8["h"], q8["scene"], H, W, attn_q8)
    ref_h2q = gate_input_q8_ref(*args)
    diff = gate_input_q8(*args).int() - ref_h2q.int()
    same = float((diff == 0).float().mean())
    print("kernel phase %s: int8 gate inputs equal to the plain version's: "
          "%.6f (max step %d)" % (what, same, int(diff.abs().max())))
    if int(diff.abs().max()) > 1 or not same >= H2Q_SAME_MIN:
        raise AssertionError(
            f"{what}: the int8 gate inputs differ from the plain version's "
            f"beyond rounding ties: {same} equal (at least {H2Q_SAME_MIN}),"
            f" max step {int(diff.abs().max())} (at most 1)")
    gate = (quant, q8["cell_b"], q8["prev_ids"], q8["parent_rows"], ref_h2q,
            q8["c"], H, W)
    _, got = gate_lstm_q8(*gate)
    torch.cuda.synchronize()
    if not c_gate(f"{what} gate launch", "kernel on the plain h2_q", got,
                  gate_lstm_q8_ref(*gate)[1]):
        raise AssertionError(f"{what}: the gate launch disagrees with the "
                             "plain gate on the same h2_q")
    return run, err, ref_h2q


def check_q8dyn(what: str, quant, q8: dict, H: int, W: int):
    """K7 against its plain version on the same card tensors: h', c' and
    logits within TOL; the attention and row-scale launches' h2_f and
    r_p against the plain ones (see H2F_ATOL). Returns the step (to
    time), its max abs err and the plain h2_f and r_p."""
    def run(fn=decode_step_gathered_q8dyn):
        return fn(quant, **q8, H=H, W=W)
    out = run()
    torch.cuda.synchronize()
    err = check_close(what, out, run(decode_step_gathered_q8dyn_ref))
    args = (q8["parent_rows"], q8["h"], q8["scene"], H, W)
    h2_f, r_p = gate_inputs_q8dyn(*args)
    ref_h2f, ref_rp = gate_inputs_q8dyn_ref(*args)
    fl = h2f_weight_flips(*args, h2_f, ref_h2f, H2F_ATOL)
    M, D = h2_f.shape
    n = fl["rows"].numel()
    explained = int(((fl["flips"] >= 1)
                     & (fl["residual"] <= H2F_ATOL)).sum())
    rp_exact = torch.equal(r_p, row_scales_q8dyn_ref(h2_f, H, W))
    rp_rel = (r_p - ref_rp).abs() / ref_rp
    print("kernel phase %s: h2_f max abs err %.3g; %d of %d pixels beyond "
          "%.0e (at most %.0e of them), %d explained by whole bf16 steps "
          "of their attention weights (weights flipped per pixel: %s; all "
          "%d channels moved in %d; max residual %.3g); r_p the exact patch "
          "max of h2_f: %s; r_p max rel err vs plain %.3g, within 1e-6 in "
          "%.7f of rows"
          % (what, float((h2_f - ref_h2f).abs().max()), n, M, H2F_ATOL,
             FLIPPED_MAX, explained, torch.bincount(fl["flips"]).tolist(),
             D, int((fl["moved"] == D).sum()),
             float(fl["residual"].max()) if n else 0.0, rp_exact,
             float(rp_rel.max()), float((rp_rel <= 1e-6).float().mean())))
    if n > FLIPPED_MAX * M or explained != n or not rp_exact:
        raise AssertionError(
            f"{what}: the gate inputs disagree with the plain version's: "
            f"{n} of {M} pixels of h2_f beyond {H2F_ATOL} (at most "
            f"{FLIPPED_MAX} of them), {explained} explained by whole bf16 "
            f"steps of attention weights; r_p the patch max of h2_f: "
            f"{rp_exact}")
    return run, err, ref_h2f, ref_rp


def check_q8dyn_rows(params, cfg, dev, NK: int, identity: bool,
                     what: str) -> None:
    """K7 held against its plain version (``check_q8dyn``) at NK rows of
    a decode: permuted parents (beam) or identity ones (greedy)."""
    ops, _, H, W = kernel_operands(params, cfg, dev, NK, identity=identity)
    quant = quantize_decode_weights_v2(
        params["scales"]["0"]["dec_class"],
        ops["emb_table"].reshape(H * W, H, W, -1))
    q8 = {k: v for k, v in ops.items() if k not in ("cell_w", "emb_table")}
    check_q8dyn("K7 at %s's %d rows" % (what, NK), quant, q8, H, W)


def kernel_phase(model, cfg, dev) -> dict:
    ops, quant, H, W = kernel_operands(model, cfg, dev,
                                       NK=16 * cfg.beam_size)
    E = ops["emb_table"].shape[-1]
    NK = ops["prev_ids"].shape[0]
    D = ops["h"].shape[-1]
    print("kernel phase: NK=%d, %dx%d, D=%d, E=%d, C=%d"
          % (NK, H, W, D, E, ops["scene"].shape[-1]))
    stats = {}

    # the gate weights in the kernel's layout, made once as a decode does
    w1 = prepare_gate_weights(ops["cell_w"], E)
    k1_out = decode_step_gathered(**ops, H=H, W=W, weights=w1)
    torch.cuda.synchronize()
    stats["K1"] = dict(
        max_abs_err=check_close("K1", k1_out,
                                decode_step_gathered_ref(**ops, H=H, W=W)),
        **timed("K1", lambda: decode_step_gathered(**ops, H=H, W=W,
                                                   weights=w1),
                lambda: decode_step_gathered_ref(**ops, H=H, W=W), reps=30,
                plain_reps=10, roof=bound(ops, H, W, E, "bf16", "bf16")))
    # information only: cuDNN's bf16 conv2d of the gate product alone
    # (no attention, no gather, no LSTM) is not a call that computes K1
    x = torch.randn(NK, E + D, H, W, device=dev, dtype=torch.bfloat16)
    w = ops["cell_w"].reshape(3, 3, E + D, 4 * D).permute(3, 2, 0, 1) \
        .contiguous()
    print("kernel phase K1: cuDNN bf16 conv2d of the gate product alone "
          "%.4f ms" % median_ms(
              lambda: torch.nn.functional.conv2d(x, w, padding=1), reps=30))
    k1_launches(ops, H, W)

    q8 = {k: v for k, v in ops.items() if k not in ("cell_w", "emb_table")}
    for name, attn_q8 in (("K2", False), ("K3", True)):
        run, err, ref_h2q = check_q8(name, quant, q8, H, W, attn_q8)
        stats[name] = dict(max_abs_err=err, **timed(
            name, run, lambda: run(decode_step_gathered_q8_ref), reps=30,
            plain_reps=5, roof=bound(ops, H, W, E, "int8",
                                      "int8" if attn_q8 else "bf16",
                                      n_scales=2)))
    q8_gate_faults(quant, q8, ref_h2q, H, W)
    launch_rates(quant, q8, ref_h2q, H, W)

    quant_dyn = quantize_decode_weights_v2(
        model["scales"]["0"]["dec_class"],
        ops["emb_table"].reshape(H * W, H, W, E))
    stats["K7"] = q8dyn_kernel_phase(
        quant_dyn, q8, H, W, bound(ops, H, W, E, "int8", "bf16", n_scales=3))
    stats.update(k8_k9_kernel_phase(model, cfg, ops, k1_out, H, W))
    stats["K6"] = cell_kernel_phase(model, cfg, dev)
    return stats


def timed(name: str, fn, ref, reps: int, plain_reps: int,
          roof: dict) -> dict:
    """Kernel and plain medians (CUDA events) beside the kernel's bound,
    and the kernel's launch breakdown (profiler)."""
    ms = median_ms(fn, reps=reps)
    plain_ms = median_ms(ref, reps=plain_reps)
    print("kernel phase %s: kernel %.4f ms, plain %.4f ms, bound %.4f ms "
          "(%s)" % (name, ms, plain_ms, roof["bound_ms"], roof["bound_by"]))
    launch_breakdown(name, fn)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, **roof)


def bf16_steps(a, b):
    """|a - b| in bf16 steps, elementwise, for two bf16 tensors."""
    def ordered(x):
        i = x.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def steps_above(a, b, floor: float):
    """|a - b| in bf16 steps of max(|a|, |b|, floor), elementwise, for two
    bf16 tensors: one step of the floor below it."""
    a, b = a.float(), b.float()
    mag = torch.clamp_min(torch.maximum(a.abs(), b.abs()), floor)
    _, e = torch.frexp(mag)
    return (a - b).abs() / torch.ldexp(torch.ones_like(mag), e - 8)


def c_gate(launch: str, what: str, got, want, limit: float = C_SAME_MIN,
           floor: float = 0.0) -> bool:
    """The gate launches' gate (K1's, K2/K3's, K7's): bf16 c' equal to the
    plain gate's in at least ``limit`` of entries, none more than one
    bf16 step off; with a ``floor``, one step of max(|c'|, floor) (K1:
    its f32 sums run in another order than the plain product's, and
    where c' = sigmoid(f) c + sigmoid(i) tanh(g) cancels to near 0 that
    noise flips its sign, thousands of steps apart). Prints the margins;
    returns whether it passes."""
    steps = bf16_steps(got, want)
    same, worst = float((steps == 0).float().mean()), int(steps.max())
    above = float(steps_above(got, want, floor).max())
    ok = same >= limit and (above <= 1 if floor else worst <= 1)
    print("kernel phase %s, %s: c' equal in %.6f of entries (at least "
          "%.6f), max %d bf16 steps%s (at most 1): %s"
          % (launch, what, same, limit, worst,
             ", max %.3f steps of max(|c'|, %g)" % (above, floor)
             if floor else "", "passes" if ok else "rejected"))
    return ok


def q8dyn_kernel_phase(quant, q8: dict, H: int, W: int,
                       k7_bound: dict) -> dict:
    """K7 against its plain version at full width (``check_q8dyn``);
    the gate launch on the plain version's own h2_f and r_p against the
    plain gate (c' equal but for rounding), a gate that must reject two
    planted faults."""
    run, err, ref_h2f, ref_rp = check_q8dyn("K7", quant, q8, H, W)
    gate = (quant, q8["cell_b"], q8["prev_ids"], q8["parent_rows"])
    _, want = gate_lstm_q8dyn_ref(*gate, ref_h2f, ref_rp, q8["c"], H, W)
    _, got = gate_lstm_q8dyn(*gate, ref_h2f, ref_rp, q8["c"], H, W)
    torch.cuda.synchronize()
    if not c_gate("K7 gate launch", "kernel on the plain inputs", got,
                  want):
        raise AssertionError("K7's gate launch disagrees with the plain "
                             "gate on the same inputs")
    h2_b = ref_h2f.to(torch.bfloat16).float()
    for what, (hf, rp) in (
            ("planted fault: recurrent half at K2's static 127/2",
             (ref_h2f, torch.full_like(ref_rp, 2.0))),
            ("planted fault: h2_f rounded to bf16 before quantising",
             (h2_b, row_scales_q8dyn_ref(h2_b, H, W)))):
        _, fault = gate_lstm_q8dyn_ref(*gate, hf, rp, q8["c"], H, W)
        if c_gate("K7 gate launch", what, fault, want):
            raise AssertionError(f"K7's gate does not reject the {what}")
    M, D = ref_h2f.shape
    E = quant.emb_q.shape[-1]
    C = q8["scene"].shape[-1]
    n_ids = int(torch.unique(q8["prev_ids"]).numel())
    launch_rate("K7 attention and row-scale launches (f32 h2_f, r_p)",
                lambda: gate_inputs_q8dyn(q8["parent_rows"], q8["h"],
                                          q8["scene"], H, W),
                ops=2.0 * M * 9 * ((D + C) + D),
                nbytes=M * D * 2 + M * C * 2 + M * D * 4 + M * 4, kind="bf16")
    launch_rate("K7 gate launch",
                lambda: gate_lstm_q8dyn(*gate, ref_h2f, ref_rp, q8["c"], H, W),
                ops=2.0 * M * 9 * (E + D) * 4 * D,
                nbytes=(M * D * 4 + M * 4 + n_ids * H * W * E + M * D * 2
                        + 4 * D * 9 * (E + D) + 3 * 4 * D * 4
                        + 2 * M * D * 2))
    return dict(max_abs_err=err, **timed(
        "K7", run, lambda: run(decode_step_gathered_q8dyn_ref), reps=30,
        plain_reps=5, roof=k7_bound))


def q8_gate_faults(quant, q8: dict, ref_h2q, H: int, W: int) -> None:
    """K2/K3's gate-launch gate (``c_gate``) must reject three planted
    layout faults, each computed with the plain gate on the plain h2_q:
    the last K tile of 128 dropped, gates i and g swapped in one
    8-column chunk, and tap s = 8 zeroed."""
    gate = (q8["cell_b"], q8["prev_ids"], q8["parent_rows"], ref_h2q,
            q8["c"], H, W)
    want = gate_lstm_q8_ref(quant, *gate)[1]
    w = quant.w_q
    D = ref_h2q.shape[-1]
    Kdim = w.shape[0]
    last = (Kdim - 1) // 128 * 128
    dropped = w.clone()
    dropped[last:] = 0
    swapped = w.clone()
    swapped[:, 0:8], swapped[:, D:D + 8] = w[:, D:D + 8], w[:, 0:8]
    tap = w.clone()
    tap[8 * (Kdim // 9):] = 0
    for what, wq in (
            (f"planted fault: the last K tile (k >= {last}) dropped",
             dropped),
            ("planted fault: gates i and g swapped in one 8-column chunk",
             swapped),
            ("planted fault: tap s = 8 zeroed", tap)):
        fault = gate_lstm_q8_ref(quant._replace(w_q=wq), *gate)[1]
        if c_gate("K2/K3 gate launch", what, fault, want):
            raise AssertionError(f"K2/K3's gate does not reject the {what}")


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of one call of ``fn``, every kernel it launches
    (torch.profiler over ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof) / reps


def k1_launches(ops: dict, H: int, W: int) -> None:
    """K1's three launches alone at these rows. The attention launch's
    bf16 h2 must equal the plain h2 in at least H2_SAME_MIN of entries;
    the gate launch (``gate_lstm_bf16``, on weights prepared once), fed
    the plain h2, must give the plain gate's c' (``c_gate`` at
    K1_C_SAME_MIN), a gate that must reject three planted layout faults
    (the last K tile of 64 dropped, gates i and g swapped in one
    8-channel chunk, tap 8 zeroed); the readout launch must agree with
    the plain readout within TOL. Then each launch is timed beside its
    bound and achieved bf16 rate."""
    NK = ops["prev_ids"].shape[0]
    HW, M = H * W, NK * H * W
    D, C = ops["h"].shape[-1], ops["scene"].shape[-1]
    E = ops["emb_table"].shape[-1]
    Kdim = 9 * (E + D)
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    h2 = gate_input_bf16(*args)
    ref_h2 = gate_input_bf16_ref(*args)
    torch.cuda.synchronize()
    steps = bf16_steps(h2, ref_h2)
    same = float((steps == 0).float().mean())
    print("kernel phase K1 attention launch: bf16 h2 equal to the plain h2 "
          "in %.6f of entries (at least %.6f; the wmma-era launch's %s), "
          "max %d bf16 steps" % (same, H2_SAME_MIN, WMMA_H2_SAME,
                                 int(steps.max())))
    if not same >= H2_SAME_MIN:
        raise AssertionError(f"K1's attention launch: h2 equal to the plain "
                             f"one in {same} (at least {H2_SAME_MIN})")
    weights = prepare_gate_weights(ops["cell_w"], E)
    gate = (ops["cell_b"], ops["prev_ids"], ops["parent_rows"],
            ops["emb_table"], ref_h2, ops["c"], H, W)
    h_out, got = gate_lstm_bf16(ops["cell_w"], *gate, weights=weights)
    want = gate_lstm_bf16_ref(ops["cell_w"], *gate)[1]
    torch.cuda.synchronize()
    print("kernel phase K1 gate launch: c' limit %.6f (C_SAME_MIN %.3f; the "
          "wmma-era launch's share %s)" % (K1_C_SAME_MIN, C_SAME_MIN,
                                           WMMA_C_SAME))
    if not c_gate("K1 gate launch", "kernel on the plain h2", got, want,
                  K1_C_SAME_MIN, C_FLOOR):
        raise AssertionError("K1's gate launch disagrees with the plain "
                             "gate on the same h2")
    w = ops["cell_w"]
    last = (Kdim - 1) // 64 * 64
    dropped, swapped, tap = w.clone(), w.clone(), w.clone()
    dropped[last:] = 0
    swapped[:, 0:8], swapped[:, D:D + 8] = w[:, D:D + 8], w[:, 0:8]
    tap[8 * (Kdim // 9):] = 0
    for what, wf in (
            (f"planted fault: the last K tile (k >= {last}) dropped",
             dropped),
            ("planted fault: gates i and g swapped in one 8-channel chunk",
             swapped),
            ("planted fault: tap s = 8 zeroed", tap)):
        fault = gate_lstm_bf16_ref(wf, *gate)[1]
        if c_gate("K1 gate launch", what, fault, want, K1_C_SAME_MIN,
                  C_FLOOR):
            raise AssertionError(f"K1's gate does not reject the {what}")
    logits = class_readout(h_out, ops["h2g_w"], H, W)
    torch.cuda.synchronize()
    err = float((logits - class_readout_ref(h_out, ops["h2g_w"], H, W))
                .abs().max())
    print("kernel phase K1 readout launch: max abs err vs plain %.3g" % err)
    if not err <= TOL:
        raise AssertionError(f"the readout launch is {err} from the plain "
                             f"readout (at most {TOL})")
    n_ids = int(torch.unique(ops["prev_ids"]).numel())
    launch_rate("K1 attention launch (bf16 h2)",
                lambda: gate_input_bf16(*args),
                ops=2.0 * M * 9 * ((D + C) + D),
                nbytes=M * D * 2 + M * C * 2 + M * D * 2, kind="bf16")
    launch_rate("K1 gate launch",
                lambda: gate_lstm_bf16(ops["cell_w"], *gate, weights=weights),
                ops=2.0 * M * Kdim * 4 * D,
                nbytes=(M * D * 2 + n_ids * HW * E * 2 + M * D * 2
                        + 4 * D * Kdim * 2 + 4 * D * 4 + 2 * M * D * 2),
                kind="bf16")
    launch_rate("readout launch (every step)",
                lambda: class_readout(h_out, ops["h2g_w"], H, W),
                ops=2.0 * M * 9 * D, nbytes=M * D * 2 + D * 9 * 2 + M * 4,
                kind="bf16")


def launch_rate(what: str, fn, ops: float, nbytes: float,
                kind: str = "int8") -> dict:
    """One launch alone: its CUDA-event median (its wrapper's host work
    included) and its profiler device time, the gap between the two,
    beside its own bound (the bytes it must move over the HBM rate, its
    ``kind`` operations over that type's peak) and its achieved rate."""
    ms = median_ms(fn, reps=30)
    dev_ms = device_ms(fn)
    host_ms = host_enqueue_ms(fn)
    roof = roofline(nbytes, {kind: ops})
    if not dev_ms > 0:   # no device time in the trace: the events' instead
        print("kernel phase %s: the profiler shows no device time; the "
              "figures below use the events' median" % what)
        dev_ms = ms
    print("kernel phase %s: %.4f ms events, %.4f ms device (events - device "
          "%.4f ms; host enqueue %.4f ms a call), bound %.4f ms (%s), %.1f%% "
          "of the bound; %.1f %s %s/s, %.2f%% of the %.0f peak"
          % (what, ms, dev_ms, ms - dev_ms, host_ms, roof["bound_ms"],
             roof["bound_by"], 100 * roof["bound_ms"] / dev_ms,
             ops / dev_ms / 1e9, kind, "TOP" if kind == "int8" else "TFLOP",
             100 * ops / (dev_ms * 1e-3) / PEAK_OPS[kind],
             PEAK_OPS[kind] / 1e12))
    return dict(ms=ms, device_ms=dev_ms, host_ms=host_ms, **roof)


def launch_rates(quant, q8: dict, ref_h2q, H: int, W: int) -> None:
    """K3's attention launch and K2/K3's gate launch alone at these rows,
    each beside its own bound; then, as information, torch._int_mm on the
    explicit im2col at the same M, K and N (the int8 GEMM alone, with no
    gather and no LSTM: the port never calls it)."""
    NK = q8["prev_ids"].shape[0]
    HW, M = H * W, NK * H * W
    D = ref_h2q.shape[-1]
    C = q8["scene"].shape[-1]
    E = quant.emb_q.shape[-1]
    Kdim = 9 * (E + D)
    n_ids = int(torch.unique(q8["prev_ids"]).numel())
    launch_rate("K2 attention launch (int8 h2_q)",
                lambda: gate_input_q8(q8["parent_rows"], q8["h"], q8["scene"],
                                      H, W, False),
                ops=2.0 * M * 9 * ((D + C) + D),
                nbytes=M * D * 2 + M * C * 2 + M * D, kind="bf16")
    launch_rate("K3 attention launch",
                lambda: gate_input_q8(q8["parent_rows"], q8["h"], q8["scene"],
                                      H, W, True),
                ops=2.0 * M * 9 * ((D + C) + D),
                nbytes=M * D * 2 + M * C * 2 + M * D)
    gate = (quant, q8["cell_b"], q8["prev_ids"], q8["parent_rows"], ref_h2q,
            q8["c"], H, W)
    launch_rate("K2/K3 gate launch", lambda: gate_lstm_q8(*gate),
                ops=2.0 * M * Kdim * 4 * D,
                nbytes=(M * D + n_ids * HW * E + M * D * 2 + 4 * D * Kdim
                        + 2 * 4 * D * 4 + 2 * M * D * 2))
    emb = quant.emb_q.reshape(HW, HW, E)[q8["prev_ids"].long()]
    a = _im2col9(torch.cat([emb, ref_h2q.reshape(NK, HW, D)], dim=-1)
                 .reshape(NK, H, W, -1)).contiguous()
    try:
        ms = "%.4f ms" % median_ms(lambda: torch._int_mm(a, quant.w_q),
                                   reps=30)
    except RuntimeError as exc:   # information only
        ms = f"not measured ({exc})"
    print("kernel phase K2/K3: torch._int_mm of the explicit im2col "
          "[%d, %d] x [%d, %d] alone %s" % (M, Kdim, Kdim, 4 * D, ms))


def k8_k9_kernel_phase(model, cfg, ops, k1_out, H: int, W: int) -> dict:
    """K8 on K1's rows gathered by hand (each row its own embedding row,
    identity parents) and K9 on the same ids with the tables of the
    model's own dec_class_emb and dec_class weights: each within TOL of
    its plain version; K8 equal to K1 within 2e-2, K9 within 5e-2 of K8
    (the JAX suite's tolerances for those comparisons)."""
    HW, D = H * W, ops["h"].shape[-1]
    E = ops["emb_table"].shape[-1]
    par = ops["parent_rows"].long()
    k8 = dict(cell_w=ops["cell_w"], cell_b=ops["cell_b"],
              h2g_w=ops["h2g_w"], scene=ops["scene"],
              emb=ops["emb_table"][ops["prev_ids"].long()].reshape(-1, E)
              .contiguous(),
              h=ops["h"].reshape(-1, HW, D)[par].reshape(-1, D).contiguous(),
              c=ops["c"].reshape(-1, HW, D)[par].reshape(-1, D).contiguous())
    # the gate weights in the kernel's layout, made once as a decode would
    w8 = prepare_gate_weights(k8["cell_w"], E)
    out8 = decode_step(**k8, H=H, W=W, weights=w8)
    torch.cuda.synchronize()
    stats = {"K8": dict(max_abs_err=check_close(
        "K8", out8, decode_step_ref(**k8, H=H, W=W)))}
    check_close("K8 vs K1 (gathered by the kernel)", out8, k1_out)

    sp = model["scales"]["0"]
    t0 = time.perf_counter()
    bg, dev = build_emb_gates_tables(sp["dec_class_emb"], sp["dec_class"],
                                     H, W, get_activation(cfg.activation))
    torch.cuda.synchronize()
    print("kernel phase K9: tables [%d, %d, %d] + [%d, 25, %d] built in "
          "%.3f s" % (H, W, 4 * D, HW, 4 * D, time.perf_counter() - t0))
    bf = torch.bfloat16
    k9 = dict(cell_b=ops["cell_b"], scene=ops["scene"], h=k8["h"],
              c=k8["c"], ids=ops["prev_ids"], emb_bg=bg, emb_dev=dev,
              cell_wh=sp["dec_class"]["kernel"][:, :, E:].to(bf)
              .reshape(9 * D, 4 * D).contiguous(),
              h2g_w=sp["h2g_class"]["w"].to(bf).reshape(9 * D, 1))
    w9 = prepare_gate_weights(k9["cell_wh"], 0)
    out9 = decode_step_v2(**k9, H=H, W=W, weights=w9)
    torch.cuda.synchronize()
    stats["K9"] = dict(max_abs_err=check_close(
        "K9", out9, decode_step_v2_ref(**k9, H=H, W=W)))
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(out9, out8)]
    print("kernel phase K9 vs K8: max abs diff h %.4g, c %.4g, logits %.4g "
          "(at most 5e-2)" % tuple(errs))
    if not max(errs) <= 5e-2:
        raise AssertionError(f"K9 is {max(errs)} from K8 (at most 5e-2)")

    for name, fn, ref, kw, wts, emb in (
            ("K8", decode_step, decode_step_ref, k8, w8, "rows"),
            ("K9", decode_step_v2, decode_step_v2_ref, k9, w9, "tables")):
        stats[name].update(timed(
            name, lambda: fn(**kw, H=H, W=W, weights=wts),
            lambda: ref(**kw, H=H, W=W),
            reps=30, plain_reps=10,
            roof=bound(ops, H, W, E, "bf16", "bf16", emb=emb)))
    return stats


def cell_kernel_phase(model, cfg, dev, N: int = 20) -> dict:
    """K6 at the training encoder's step (N = 20, 18x32, Cx =
    scene_conv_dim = 64, D = 256, the model's enc_class weights): within
    TOL of its plain version; timed beside the port's composed bf16
    convlstm_step (cuDNN conv plus elementwise), which is information,
    not a library yardstick: no single PyTorch call computes the cell."""
    H, W = cfg.scene_grids[0]
    D, Cx = cfg.enc_hidden_size, cfg.scene_conv_dim
    params = model["scales"]["0"]["enc_class"]
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand(N, H, W, Cx, generator=g, device=dev)
    st = ConvLSTMState(c=torch.randn(N, H, W, D, generator=g, device=dev),
                       h=torch.tanh(torch.randn(N, H, W, D, generator=g,
                                                device=dev)))
    wts = prepare_gate_weights(
        params["kernel"].to(torch.bfloat16).reshape(-1, 4 * D), Cx)
    h, out = convlstm_step_fused(params, x, st, weights=wts)
    torch.cuda.synchronize()
    ref_h, ref = convlstm_step_fused_ref(params, x, st)
    err = check_close("K6", (h, out.c), (ref_h, ref.c))
    M = N * H * W
    # x, h, c, weights and bias read; h', c' written
    k6_bound = roofline(
        M * Cx * 2 + 2 * M * D * 2 + 9 * (Cx + D) * 4 * D * 2 + 4 * D * 4
        + 2 * M * D * 2, {"bf16": 2.0 * M * 9 * (Cx + D) * 4 * D})
    stats = dict(max_abs_err=err, **timed(
        "K6", lambda: convlstm_step_fused(params, x, st, weights=wts),
        lambda: convlstm_step_fused_ref(params, x, st), reps=50,
        plain_reps=20, roof=k6_bound))
    print("kernel phase K6: N=%d, %dx%d, Cx=%d, D=%d; the port's composed "
          "bf16 convlstm_step (cuDNN conv + elementwise) %.4f ms"
          % (N, H, W, Cx, D, median_ms(lambda: convlstm_step(
              params, x, st, compute_dtype=torch.bfloat16), reps=50)))
    return stats


# ---------------------------------------------------------------- offline


def check_pickles(out, prob, inputs, cfg) -> None:
    H, W = cfg.scene_grids[0]
    K = cfg.beam_size
    with tempfile.TemporaryDirectory() as tmp:
        traj_p = os.path.join(tmp, "out.traj.p")
        prob_p = os.path.join(tmp, "out.prob.p")
        inference.save_outputs(out, prob, traj_p, prob_p)
        with open(traj_p, "rb") as f:
            trajs = pickle.load(f)
        with open(prob_p, "rb") as f:
            probs = pickle.load(f)
    if set(trajs) != set(inputs.traj_ids) or set(probs) != set(trajs):
        raise AssertionError("pickles do not cover every trajectory")
    for n, tid in enumerate(inputs.traj_ids):
        T = int(inputs.pred_lengths[n])
        pts = np.asarray(trajs[tid], np.float32)
        logits, logprobs = probs[tid]
        if pts.shape != (K, T, 2) or not np.isfinite(pts).all():
            raise AssertionError(f"{tid}: trajectories {pts.shape}")
        if logits.shape != (1, K, T, H * W) or logits.dtype != np.float32 \
                or not np.isfinite(logits).all():
            raise AssertionError(f"{tid}: beam logits {logits.shape}")
        if logprobs.shape != (1, K) or not np.isfinite(logprobs).all():
            raise AssertionError(f"{tid}: beam logprobs {logprobs.shape}")


def reset_launches() -> None:
    decode_step_gathered.launches = 0
    decode_step_gathered_q8.launches = {"int8": 0, "int8a": 0}
    decode_step_gathered_q8dyn.launches = 0
    gnn_dense_fwd.launches = 0
    gnn_dense_bwd.launches = 0


# the wrappers of the kernels that no path of the port runs, as in the JAX
# package: their main-path launches are 0, and the kernel phases hold
# them against their plain versions
PATHLESS = {"K6": convlstm_step_fused, "K8": decode_step,
            "K9": decode_step_v2}


def tier_launches(tier: str) -> int:
    """Launches of the decode step of a ``decode_quant`` tier."""
    if tier == "none":
        return decode_step_gathered.launches
    if tier == "int8_dyn":
        return decode_step_gathered_q8dyn.launches
    return decode_step_gathered_q8.launches[tier]


def check_greedy_trajs(out, inputs, cfg) -> None:
    for n, tid in enumerate(inputs.traj_ids):
        pts = np.asarray(out[tid], np.float32)
        shape = (cfg.beam_size, int(inputs.pred_lengths[n]), 2)
        if pts.shape != shape or not np.isfinite(pts).all() \
                or not (pts == pts[:1]).all():
            raise AssertionError(f"{tid}: greedy trajectories {pts.shape}")


def offline_run(model, cfg, inputs, dev, tier: str,
                greedy: bool = False) -> int:
    """One tier of the offline path: a counted first run whose pickles
    are checked (greedy: the one future, ``--num_out`` times), then a
    timed second one. Returns the kernel launches of the first run."""
    cfg = cfg.replace(decode_quant=tier)
    what = tier + (" greedy" if greedy else "")
    batch_size = 16
    T = int(inputs.pred_lengths.max())
    n_batches = -(-len(inputs.traj_ids) // batch_size)

    def run():
        return inference.run_multifuture_inference(
            model, inputs, cfg, batch_size=batch_size, need_prob=not greedy,
            greedy=greedy, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, prob = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = tier_launches(tier)
    print("offline %s: %d trajectories, %d batches, T=%d, %d kernel "
          "launches, first run %.3f s" % (what, len(inputs.traj_ids),
                                          n_batches, T, launches, first_s))
    if launches != n_batches * T:
        raise AssertionError(f"the {what} decode ran {launches} kernel "
                             f"steps, expected {n_batches} x {T}")
    if greedy:
        check_greedy_trajs(out, inputs, cfg)
    else:
        check_pickles(out, prob, inputs, cfg)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    print("offline %s: %.2f traj/s (second run, %.3f s, %s)"
          % (what, len(inputs.traj_ids) / steady_s, steady_s,
             ".traj.p output" if greedy else ".traj.p and .prob.p outputs"))
    return launches


def id_agreement(model, cfg, inputs, dev, tier: str = "none",
                 other: str = "plain") -> None:
    """Beam ids of batch 0 in ``tier`` through its kernel against
    ``other``: the plain version of the same tier, or another tier's
    kernel (information: bf16 near-ties flip ids)."""
    batch_size = 16
    T = int(inputs.pred_lengths.max())
    batch = batch_to_device(
        inference.make_batch(inputs, np.arange(batch_size), cfg), dev)
    with torch.inference_mode():
        beam_k, _ = inference.beam_forward(
            model, batch, cfg.replace(decode_quant=tier), T_pred=T)
        if other == "plain":
            # the plain step has no kernel layout to take
            def plain(*args, weights=None, **kw):
                return decode_step_gathered_ref(*args, **kw)
            with mock.patch.object(quant_ops, "decode_step_gathered", plain):
                beam_p, _ = inference.beam_forward(model, batch, cfg,
                                                   T_pred=T)
        else:
            beam_p, _ = inference.beam_forward(
                model, batch, cfg.replace(decode_quant=other), T_pred=T)
    lengths = batch.pred_length.cpu().numpy()
    ids_k, ids_p = beam_k.ids.cpu().numpy(), beam_p.ids.cpu().numpy()
    agree = np.mean(np.concatenate([
        (ids_k[n, :, :lengths[n]] == ids_p[n, :, :lengths[n]]).ravel()
        for n in range(batch_size)]))
    step0 = float((beam_k.logits[:, :, 0] - beam_p.logits[:, :, 0])
                  .abs().max())
    print("offline %s: beam ids of batch 0 agreeing with %s: %.4f; step-0 "
          "logits max abs diff %.3g"
          % (tier, "the plain version" if other == "plain"
             else f"the {other} tier", agree, step0))


# ------------------------------------------------------------------ serve


def direct_forward(engine, cfg, obs, pred_len: int, params=None):
    """A direct forward of one request on ``params`` (default: the
    engine's), in every row of a batch of the engine's shape. Returns
    [K, pred_len, 2] points (greedy: the one future) and the [K] beam
    log-probs (greedy: None). The beam order depends on pred_len
    (finished beams freeze)."""
    dev = engine.device
    params = engine._params if params is None else params
    B, T = engine.max_batch, engine.T_pred
    raw = RawInputs(
        obs_xy=torch.as_tensor(np.tile(obs[None], (B, 1, 1)), device=dev),
        obs_scene=torch.arange(B * cfg.obs_len, dtype=torch.int32,
                               device=dev).reshape(B, cfg.obs_len),
        scene_feat=engine._default_scene,
        pred_length=torch.full((B,), pred_len, dtype=torch.int32,
                               device=dev))
    logprobs = None
    with torch.inference_mode():
        batch = rasterize_batch(raw, cfg, engine._centers_hw)
        if engine.greedy:
            logits, reg = inference.greedy_forward(params, batch, cfg,
                                                   T_pred=T)
            trajs = inference.reconstruct_greedy_trajs(
                logits, reg, engine._centers)[:1]
        else:
            beam, reg = inference.beam_forward(params, batch, cfg, T_pred=T)
            trajs = inference.reconstruct_beam_trajs(
                beam.ids, reg, engine._centers)[0]
            logprobs = beam.logprobs[0].float().cpu().numpy()
    return trajs[:, :pred_len].cpu().numpy(), logprobs


def serve_burst(engine, cfg, server, what: str, obs, pred_lens,
                n_threads: int) -> int:
    """Sends every request from ``n_threads`` client threads over HTTP;
    checks the responses and that every batch ran T kernel steps of the
    engine's tier. Returns the tier's kernel launches of the burst."""
    tier = cfg.decode_quant
    n_requests = len(obs)
    results = [None] * n_requests
    errors = []

    def client(k):
        cl = PredictionClient(port=server.port, binary=True)
        try:
            for n in range(k, n_requests, n_threads):
                results[n] = cl.predict(obs[n], pred_len=pred_lens[n])
        except Exception as exc:   # re-raised below
            errors.append(exc)
        finally:
            cl.close()

    engine.stats.reset()
    reset_launches()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = tier_launches(tier)
    stats = engine.stats.snapshot()
    if errors:
        raise errors[0]
    for n, r in enumerate(results):
        shape = (cfg.beam_size, int(pred_lens[n]), 2)
        if r["trajs"].shape != shape or r["pred_len"] != pred_lens[n] \
                or not np.isfinite(r["trajs"]).all() \
                or not np.isfinite(r["logprobs"]).all():
            raise AssertionError(f"{what} response {n}: "
                                 f"{r['trajs'].shape}, expected {shape}")
    if launches != stats["batches"] * engine.T_pred:
        raise AssertionError(
            f"{what}: the {tier} kernel ran {launches} steps for "
            f"{stats['batches']} batches x T={engine.T_pred}")
    want, _ = direct_forward(engine, cfg, obs[0], int(pred_lens[0]))
    diff = float(np.abs(results[0]["trajs"] - want).max())
    # a smoke reading, not a serving metric: too few requests for a
    # tail percentile (the max is given), batches mostly padding
    padding = 1.0 - stats["requests"] / (stats["batches"] * engine.max_batch)
    print("serve %s: max_batch %d, T=%d, %d requests from %d threads in "
          "%.3f s: %.2f req/s; latency p50 %s ms, p99 %s ms, max %s ms "
          "(under 100 requests p99 is the max); %d batches, padding share "
          "%.4f; %d %s launches; served vs direct forward: max abs diff "
          "%.3g px"
          % (what, engine.max_batch, engine.T_pred, n_requests, n_threads,
             wall, n_requests / wall, stats.get("p50_latency_ms"),
             stats.get("p99_latency_ms"), stats["max_latency_ms"],
             stats["batches"], padding, launches, tier, diff))
    if not diff <= 1e-3:
        raise AssertionError(f"{what}: a served result differs from a "
                             f"direct forward by {diff} px")
    return launches


SERVERS = (("asyncio", AsyncPredictionServer), ("threads", PredictionServer))


def serve_phase(flags, dev, greedy: bool, n_requests: int,
                n_threads: int = 4, tier: str = "int8a",
                servers=SERVERS) -> int:
    """Serve requests over HTTP through mvt-torch-serve's engine and its
    front ends (by default both: asyncio, its default, then threads);
    returns the tier's kernel launches of the traffic. ``tier`` is the
    tier the flags must select (int8a is the default on cuda). Before
    the traffic, the tier's kernel (K3 or K7) is held against its plain
    version at the rows the engine gives it."""
    argv = ["out", "model", "--random_init", "--port", "0", *flags] \
        + (["--greedy"] if greedy else [])
    args = serve.build_parser().parse_args(argv)
    args.compute_dtype, args.decode_quant = serve.resolve_serving_dtypes(
        dev.type, args.compute_dtype, args.decode_quant)
    args.max_batch = serve.resolve_max_batch(args.max_batch, args.greedy)
    cfg = serve.config_from_args(args).replace(
        use_beam_search=not greedy).validate()
    if (cfg.compute_dtype, cfg.decode_quant) != ("bfloat16", tier):
        raise AssertionError(f"the serving tier must be bf16 + {tier}, got "
                             f"{cfg.compute_dtype} + {cfg.decode_quant}")
    engine = serve.ServingEngine(
        serve.load_model(args, cfg)[0], cfg, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, device=dev)
    what = ("greedy" if greedy else "beam") + \
        ("" if tier == "int8a" else f" {tier}")
    try:
        warm_s = engine.warmup()
        # greedy decodes one row per request with identity parents, beam
        # K rows per request with parents permuted
        NK = engine.max_batch * (1 if greedy else cfg.beam_size)
        if tier == "int8a":
            ops, quant, H, W = kernel_operands(engine._params, cfg, dev, NK,
                                               identity=greedy)
            q8 = {k: v for k, v in ops.items()
                  if k not in ("cell_w", "emb_table")}
            check_q8("K3 at serve %s's %d rows" % (what, NK), quant, q8, H,
                     W, attn_q8=True)
        else:
            check_q8dyn_rows(engine._params, cfg, dev, NK, greedy,
                             "serve " + what)
        print("serve %s: warm-up %.3f s" % (what, warm_s))
        rng = np.random.RandomState(3)
        obs = [np.stack([rng.uniform(0, cfg.video_w, cfg.obs_len),
                         rng.uniform(0, cfg.video_h, cfg.obs_len)],
                        axis=1).astype(np.float32)
               for _ in range(n_requests)]
        pred_lens = rng.randint(1, engine.T_pred + 1, n_requests)
        launches = 0
        for backend, server_cls in servers:
            server = server_cls(engine, host=args.host, port=0)
            server.start_background()
            try:
                launches += serve_burst(
                    engine, cfg, server, f"{what} ({backend})", obs,
                    pred_lens, n_threads)
            finally:
                server.close(close_engine=False)
        return launches
    finally:
        engine.close()


# --------------------------------------------------------------- training


def gnn_operands(model, cfg, dev, N: int = 20) -> dict:
    """K4/K5 operand sets at the training shape (bf16 node rows from
    ``normalised_node``, bf16 states, one unit-normal f32 cotangent):

    * "encoder": the model's class-encoder last hidden state and
      time-averaged scene features of a synthetic batch of N, as the
      training decode's first GNN step sees them. With zero ConvLSTM
      biases most of that h is exactly 0 away from the observed cells,
      so dnode is small there;
    * "dense": tanh(randn) states and uniform scene features, every row
      and every product well away from 0."""
    inputs = inference.synthesize_multifuture_inputs(cfg, N, seed=2)
    batch = batch_to_device(
        inference.make_batch(inputs, np.arange(N), cfg), dev)
    with torch.inference_mode():
        _, enc_last, scene_mean = inference._encode(model, batch, cfg,
                                                    torch.bfloat16)
    bf = torch.bfloat16
    h, scene = enc_last.h.to(bf), scene_mean.to(bf)
    N, H, W, D = h.shape
    g = torch.Generator(device=dev).manual_seed(3)
    dense_h = torch.tanh(torch.randn(h.shape, generator=g, device=dev))
    dense_scene = torch.rand(scene.shape, generator=g, device=dev)
    cot = torch.randn(N * H * W, D, generator=g, device=dev)
    sets = {}
    for name, hh, ss in (("encoder", h, scene),
                         ("dense", dense_h.to(bf), dense_scene.to(bf))):
        node = normalised_node(hh, ss)
        sets[name] = (node.reshape(N * H * W, -1).contiguous().clone(),
                      hh.reshape(N * H * W, D).contiguous().clone(), cot)
    return sets, H, W


def dnode_without_transpose(node, states, g, H: int, W: int):
    """A planted K5 fault: dnode = dedges . node, the dedges^T term left
    out (otherwise :func:`gnn_dense_bwd_ref`'s formulas)."""
    HW = H * W
    attn = fused_gnn._dense_attn(node, H, W)
    s = states.reshape(-1, HW, states.shape[-1]).float()
    g_c = g.reshape(-1, HW, states.shape[-1]).to(states.dtype).float()
    dattn = g_c @ s.transpose(1, 2)
    dedges = attn * (dattn - torch.sum(dattn * attn, dim=-1, keepdim=True))
    n = node.reshape(-1, HW, node.shape[-1]).float()
    return (dedges.to(node.dtype).float() @ n).to(node.dtype).reshape(
        node.shape)


def gnn_gate(got, want, cap: float = float("inf")) -> dict:
    """K4/K5's gate: max abs error against the plain version within TOL
    x max |plain| (K4 also within TOL: ``cap`` 1), relative with no
    floor, so a small output is held to its own scale."""
    want = want.float()
    peak = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    return {"err": err, "max_plain": peak,
            "mean_plain": float(want.abs().mean()),
            "limit": TOL * min(cap, peak), "ok": err <= TOL * min(cap, peak)}


def gnn_bounds(node, states, H: int, W: int) -> dict:
    """Least times of K4 and K5 on these inputs: bytes (each input read
    once, each output written once) over the HBM rate against the
    banded products' operations (only the in-grid neighbour pairs these
    shapes have) over the bf16 tensor-core peak."""
    NHW, Dn = node.shape
    Ds = states.shape[-1]
    pairs = NHW // (H * W) * (3 * H - 2) * (3 * W - 2)
    out = {}
    for name, nbytes, ops in (
            ("K4", NHW * (Dn * 2 + Ds * 2 + Ds * 4),
             2.0 * pairs * (Dn + Ds)),
            ("K5", NHW * (Dn * 2 + Ds * 2 + Ds * 4 + Dn * 2 + Ds * 2),
             2.0 * pairs * 2 * (Dn + Ds))):
        bytes_s, ops_s = nbytes / HBM_BYTES_S, ops / PEAK_OPS["bf16"]
        out[name] = {"bound_ms": max(bytes_s, ops_s) * 1e3,
                     "bound_by": "operations" if ops_s >= bytes_s
                     else "bytes"}
    return out


def gnn_kernel_phase(model, cfg, dev, N: int = 20) -> dict:
    """K4 and K5 against their plain versions at N samples (20, the
    training shape; SimAug's 36 and 12), timed beside the plain versions
    and SDPA."""
    sets, H, W = gnn_operands(model, cfg, dev, N)
    node, states, cot = sets["encoder"]
    print("training-kernel phase: N=%d, %dx%d, node %d, states %d"
          % (node.shape[0] // (H * W), H, W, node.shape[1], states.shape[1]))
    errs = {"K4": 0.0, "K5": 0.0}
    outs, failed, planted_passed = {}, [], []
    for set_name, (nd, st, gg) in sets.items():
        out = outs[set_name] = gnn_dense_fwd(nd, st, H, W)
        dnode, dstates = gnn_dense_bwd(nd, st, gg, H, W)
        torch.cuda.synchronize()
        ref = gnn_dense_fwd_ref(nd, st, H, W)
        ref_dnode, ref_dstates = gnn_dense_bwd_ref(nd, st, gg, H, W)
        for kname, oname, got, want, cap in (
                ("K4", "out", out, ref, 1.0),
                ("K5", "dnode", dnode, ref_dnode, float("inf")),
                ("K5", "dstates", dstates, ref_dstates, float("inf"))):
            r = gnn_gate(got, want, cap)
            errs[kname] = max(errs[kname], r["err"])
            print("training-kernel phase %s %s (%s operands): max abs err "
                  "%.6g, limit %.6g; max |plain| %.6g, mean |plain| %.6g"
                  % (kname, oname, set_name, r["err"], r["limit"],
                     r["max_plain"], r["mean_plain"]))
            if not r["ok"]:
                failed.append(f"{kname} {oname} ({set_name})")
        # the gate must reject these faults on this run's own data
        for what, got, want, cap in (
                ("K4 out = 0", torch.zeros_like(ref), ref, 1.0),
                ("K5 dnode = 0", torch.zeros_like(ref_dnode), ref_dnode,
                 float("inf")),
                ("K5 dnode without dedges^T",
                 dnode_without_transpose(nd, st, gg, H, W), ref_dnode,
                 float("inf")),
                ("K5 dstates = 0", torch.zeros_like(ref_dstates),
                 ref_dstates, float("inf"))):
            r = gnn_gate(got, want, cap)
            verdict = "passes" if r["ok"] else "rejected"
            print("training-kernel phase: planted fault %s (%s operands): "
                  "err %.6g, limit %.6g, %s"
                  % (what, set_name, r["err"], r["limit"], verdict))
            if r["ok"]:
                planted_passed.append(f"{what} ({set_name})")
    if failed:
        raise AssertionError("K4/K5 disagree with their plain versions: "
                             + ", ".join(failed))
    if planted_passed:
        raise AssertionError("the K4/K5 gate does not reject planted "
                             "faults: " + ", ".join(planted_passed))
    out = outs["encoder"]

    # the library yardstick: SDPA computes K4's function (scale 1, the
    # additive mask), and dnode = dq + dk; timed, never used by the port
    N = node.shape[0] // (H * W)
    q = node.reshape(N, 1, H * W, -1).detach().clone().requires_grad_()
    k = node.reshape(N, 1, H * W, -1).detach().clone().requires_grad_()
    v = states.reshape(N, 1, H * W, -1).detach().clone().requires_grad_()
    bias = _neighbor_bias(H, W, dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
        q, k, v, bias, 0.0, False, scale=1.0)).name
    lib_out = sdpa(q, k, v, attn_mask=bias, scale=1.0)
    g_out = cot.reshape(lib_out.shape).to(lib_out.dtype)

    def lib_bwd():
        dq, dk, dv = torch.autograd.grad(lib_out, (q, k, v), g_out,
                                         retain_graph=True)
        return dq + dk, dv

    with torch.no_grad():
        lib_fwd_ms = median_ms(
            lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0), reps=30)
    lib_bwd_ms = median_ms(lib_bwd, reps=30)
    lib_err = float((lib_out.detach().reshape(out.shape).float() - out)
                    .abs().max())

    bounds = gnn_bounds(node, states, H, W)
    stats = {}
    for name, fn, ref, err, lib_ms in (
            ("K4", lambda: gnn_dense_fwd(node, states, H, W),
             lambda: gnn_dense_fwd_ref(node, states, H, W), errs["K4"],
             lib_fwd_ms),
            ("K5", lambda: gnn_dense_bwd(node, states, cot, H, W),
             lambda: gnn_dense_bwd_ref(node, states, cot, H, W), errs["K5"],
             lib_bwd_ms)):
        ms = median_ms(fn, reps=50)
        plain_ms = median_ms(ref, reps=20)
        stats[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, **bounds[name])
        print("training-kernel phase %s: kernel %.4f ms, plain %.4f ms, "
              "SDPA %s %.4f ms (backend %s), bound %.4f ms (%s)"
              % (name, ms, plain_ms, "forward" if name == "K4"
                 else "backward", lib_ms, backend, bounds[name]["bound_ms"],
                 bounds[name]["bound_by"]))
        per_launch = launch_breakdown(name, fn)
        dev_ms = sum(per_launch.values())
        if not dev_ms > 0:
            print("training-kernel phase %s: the profiler shows no device "
                  "time; the figures below use the events' median" % name)
            dev_ms = ms
        host_ms = host_enqueue_ms(fn)
        print("training-kernel phase %s: %.4f ms events, %.4f ms device "
              "(%s; events - device %.4f ms), host enqueue %.4f ms a call; "
              "%.1f%% of the bound"
              % (name, ms, dev_ms, ", ".join("%s %.4f" % kv for kv in
                                             per_launch.items()),
                 ms - dev_ms, host_ms,
                 100 * bounds[name]["bound_ms"] / dev_ms))
    print("training-kernel phase: SDPA forward vs K4 max abs diff %.4g "
          "(bf16 output)" % lib_err)
    return stats


class StepRecorder:
    """Wraps a train-step factory (``make_train_step``,
    ``make_simaug_train_step``) for a command's ``main``: keeps every
    step's total loss on the device (no sync)."""

    def __init__(self, make_step):
        self.make_step = make_step
        self.losses = []

    def __call__(self, *args):
        step = self.make_step(*args)

        def recorded(*args, **kw):
            parts = step(*args, **kw)
            self.losses.append(parts["total"])
            return parts

        return recorded


def device_busy_ms(prof) -> float:
    return sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.self_device_time_total > 0) / 1e3


@contextlib.contextmanager
def plain_gnn():
    """K4/K5's wrappers replaced by their plain versions (on the card)."""
    with mock.patch.object(fused_gnn, "gnn_dense_fwd", gnn_dense_fwd_ref), \
            mock.patch.object(fused_gnn, "gnn_dense_bwd", gnn_dense_bwd_ref):
        yield


def grad_agreement(model, batch, cfg) -> None:
    """One train step's loss and gradients through K4/K5 and through
    their plain versions, on the same weights and card batch."""
    grads_k, parts_k = trainer.loss_and_grads(model, batch, cfg)
    with plain_gnn():
        grads_p, parts_p = trainer.loss_and_grads(model, batch, cfg)
    compare_step("train phase", grads_k, float(parts_k["total"]), grads_p,
                 float(parts_p["total"]))


def compare_step(what: str, grads_k, loss_k: float, grads_p,
                 loss_p: float) -> None:
    """A step's loss within 1e-2 relative and every gradient within
    2e-2 relative L2 of the plain versions' step."""
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = 0.0, None
    for name, gp in grads_p.items():
        gk = grads_k[name].float()
        norm = float(gp.float().norm())
        rel = float((gk - gp.float()).norm()) / norm if norm > 0 \
            else float(gk.norm())
        if rel > worst:
            worst, worst_name = rel, name
    print("%s: kernel vs plain train step: loss %.6f vs %.6f "
          "(rel %.3g); worst gradient rel L2 %.4g (%s)"
          % (what, loss_k, loss_p, loss_rel, worst, worst_name))
    if not loss_rel <= 1e-2 or not worst <= 2e-2:
        raise AssertionError("%s: the kernel train step disagrees with the "
                             "plain one" % what)


def write_raw_dataset(root: str, cfg, seed: int = 0):
    """TRAINING.md section 1's inputs in the reference's on-disk format:
    per-video trajectory TSVs (frame, person, x, y at 2.5 fps of a 30 fps
    video), a uint8 scene class map per frame at the configuration's
    scene size, and the scene id json. Persons walk at a constant
    velocity with a little noise, inside the frame. Returns (traj_path,
    scene_path, id2name_path)."""
    rng = np.random.RandomState(seed)
    traj_path = os.path.join(root, "traj_2.5fps")
    scene_path = os.path.join(root, "scene_seg")
    size = np.array([cfg.video_w, cfg.video_h], np.float32)
    for split, n_videos in RAW_VIDEOS.items():
        os.makedirs(os.path.join(traj_path, split))
        for v in range(n_videos):
            name = "VIRAT_S_%s_%04d" % (split, v)
            os.makedirs(os.path.join(scene_path, name))
            start = rng.uniform(0.2, 0.8, (RAW_PERSONS, 2)) * size
            velocity = rng.randn(RAW_PERSONS, 2) * 0.01 * size
            xy = start + velocity * np.arange(RAW_FRAMES)[:, None, None] \
                + rng.randn(RAW_FRAMES, RAW_PERSONS, 2) * 0.002 * size
            xy = np.clip(xy, 1.0, size - 1.0)
            scene_map = rng.randint(0, cfg.scene_class,
                                    (cfg.scene_h, cfg.scene_w)).astype(np.uint8)
            lines = []
            for f in range(RAW_FRAMES):
                frame_idx = f * 12
                lines += ["%d\t%d\t%.3f\t%.3f" % (frame_idx, p, *xy[f, p])
                          for p in range(RAW_PERSONS)]
                np.save(os.path.join(scene_path, name, "%s_F_%08d.npy"
                                     % (name, frame_idx)), scene_map)
            with open(os.path.join(traj_path, split, name + ".txt"),
                      "w") as fh:
                fh.write("\n".join(lines) + "\n")
    id2name = os.path.join(root, "scene36_64_id2name_top10.json")
    with open(id2name, "w") as fh:
        json.dump({"oldid2new": {str(i): i for i in range(1, cfg.scene_class)},
                   "id2name": {str(i): "class%d" % i
                               for i in range(1, cfg.scene_class)}}, fh)
    return traj_path, scene_path, id2name


def preprocess_phase(root: str, cfg) -> str:
    """``mvt-torch-preprocess``'s own main with TRAINING.md section 1's
    flags on raw files written here; returns the prepro directory."""
    traj_path, scene_path, id2name = write_raw_dataset(root, cfg)
    prepro = os.path.join(root, "prepro")
    t0 = time.perf_counter()
    preprocess_cli.main([traj_path, prepro, "--scene_feat_path", scene_path,
                         "--scene_id2name", id2name, *PREPRO_FLAGS])
    dt = time.perf_counter() - t0
    counts = {}
    for split in RAW_VIDEOS:
        with np.load(os.path.join(prepro, "data_%s.npz" % split),
                     allow_pickle=True) as d:
            counts[split] = len(d["obs_traj"])
            if split == "train" and d["scene_feat"].shape[1:] != (
                    cfg.scene_h, cfg.scene_w, cfg.scene_class):
                raise AssertionError("preprocess phase: scene features "
                                     f"{d['scene_feat'].shape}")
    want = {s: n * RAW_PERSONS * (RAW_FRAMES - cfg.seq_len + 1)
            for s, n in RAW_VIDEOS.items()}
    print("preprocess phase: mvt-torch-preprocess wrote %s examples in "
          "%.3f s, %.1f examples/s (host numpy)"
          % (counts, dt, sum(counts.values()) / dt))
    if counts != want or counts["train"] != TRAIN_EXAMPLES \
            or counts["val"] != VAL_EXAMPLES:
        raise AssertionError(f"preprocess phase: {counts} examples, "
                             f"expected {want}")
    return prepro


def train_config() -> MultiverseConfig:
    """The configuration ``mvt-torch-train`` makes of TRAIN_FLAGS."""
    return train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["prepro", "out", "multiverse", *TRAIN_FLAGS]))


def train_phase(dev, tmp: str) -> dict:
    """mvt-torch-train end to end on the card, on data that
    mvt-torch-preprocess made (``tmp``/prepro; the run lands in
    ``tmp``/out/multiverse/00); returns the launches of K4, K5 and the
    evals' K1."""
    cfg = train_config()
    prepro = preprocess_phase(tmp, cfg)
    rec = StepRecorder(parallel.make_sharded_train_step)
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(train_cli, "make_sharded_train_step", rec):
        train_cli.main([prepro, os.path.join(tmp, "out"), "multiverse",
                        *TRAIN_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(rec.losses)
    losses = torch.stack(rec.losses).cpu().numpy()
    launches = {"K4": gnn_dense_fwd.launches,
                "K5": gnn_dense_bwd.launches,
                "K1": decode_step_gathered.launches}
    run = os.path.join(tmp, "out", "multiverse", "00")
    with open(os.path.join(run, "val_perf.json")) as f:
        val_perf = json.load(f)
    eval_batches = len(val_perf["val_perf"]) * (
        -(-VAL_EXAMPLES // cfg.batch_size))
    print("train phase: %d steps in %.3f s (main, evals and saves "
          "included); first loss %.4f, last 10 mean %.4f; launches K4 "
          "%d, K5 %d, eval K1 %d (%d eval batches)"
          % (steps, wall, losses[0], losses[-10:].mean(), launches["K4"],
             launches["K5"], launches["K1"], eval_batches))
    if steps != 2 * TRAIN_EXAMPLES // cfg.batch_size \
            or not np.isfinite(losses).all():
        raise AssertionError(f"train phase: {steps} steps, losses "
                             f"finite: {np.isfinite(losses).all()}")
    if launches["K4"] != steps * cfg.pred_len \
            or launches["K5"] != steps * cfg.pred_len:
        raise AssertionError(f"train phase: K4/K5 ran {launches['K4']}/"
                             f"{launches['K5']} times for {steps} steps "
                             f"x {cfg.pred_len}")
    if launches["K1"] != eval_batches * cfg.pred_len:
        raise AssertionError(f"train phase: the evals' K1 ran "
                             f"{launches['K1']} times for "
                             f"{eval_batches} batches x {cfg.pred_len}")
    if not losses[-10:].mean() < losses[0]:
        raise AssertionError("train phase: the loss did not fall")
    model = best_checkpoint_decodes("train phase", run,
                                    val_perf["best"]["step"], cfg, dev)

    ds = read_data(prepro, "train", cfg)
    batch = batch_to_device(ds.make_batch(list(range(20)))[0], dev)
    model = model.to(dev).requires_grad_(True)
    grad_agreement(model, batch, cfg)

    tx = trainer.build_optimizer(cfg, TRAIN_EXAMPLES)
    opt_state = tx.init(dict(model.named_parameters()))
    step = trainer.make_train_step(cfg, tx)
    launches["throughput"] = step_throughput(
        "train phase", lambda: step(model, opt_state, batch),
        cfg.batch_size)
    return launches


# ------------------------------------------------------------ lifecycle


def lifecycle_phase(dev, tmp: str) -> dict:
    """The published flow's last steps on phase 6's run
    (``tmp``/out/multiverse/00): mvt-torch-serve's own main loads it
    from the run directory (no --load_from, no --random_init) in its cuda
    tier with --reload_poll_s; requests go over HTTP to its asyncio front
    end; a step trained further lands in ``save`` and is hot-reloaded;
    then the offline int8a decode of that step through the inference
    command's model_path. Returns the main-path launches of K3, K4 and
    K5."""
    outbase = os.path.join(tmp, "out")
    save_dir = os.path.join(outbase, "multiverse", "00", "save")
    served_step = list_steps(save_dir)[-1][0]
    launches = {"K3": 0, "K4": 0, "K5": 0}

    def drive(server):
        """In place of the front end's wait: the phase's traffic."""
        engine = server.engine
        cfg = engine.cfg
        if (cfg.compute_dtype, cfg.decode_quant, engine.max_batch,
                cfg.beam_size) != ("bfloat16", "int8a", 8, 20):
            raise AssertionError(
                "lifecycle: served %s + %s, max_batch %d, K = %d"
                % (cfg.compute_dtype, cfg.decode_quant, engine.max_batch,
                   cfg.beam_size))
        NK = engine.max_batch * cfg.beam_size
        ops, quant, H, W = kernel_operands(engine._params, cfg, dev, NK)
        q8 = {k: v for k, v in ops.items()
              if k not in ("cell_w", "emb_table")}
        check_q8("K3 at the served run's %d rows" % NK, quant, q8, H, W,
                 attn_q8=True)
        rng = np.random.RandomState(4)
        obs = [np.stack([rng.uniform(0, cfg.video_w, cfg.obs_len),
                         rng.uniform(0, cfg.video_h, cfg.obs_len)],
                        axis=1).astype(np.float32) for _ in range(32)]
        pred_lens = rng.randint(1, engine.T_pred + 1, len(obs))
        launches["K3"] += serve_burst(
            engine, cfg, server, "lifecycle step %d (asyncio)" % served_step,
            obs, pred_lens, n_threads=4)

        T, probe = engine.T_pred, obs[0]
        client = PredictionClient(port=server.port, binary=True)
        try:
            before = client.predict(probe, pred_len=T)
            old_trajs, old_logprobs = direct_forward(engine, cfg, probe, T)
            new_step, path, renamed = train_further(dev, tmp, save_dir,
                                                    launches)
            deadline = renamed + 60
            while True:
                got = client.predict(probe, pred_len=T)
                if not np.array_equal(got["logprobs"], before["logprobs"]):
                    break
                if time.perf_counter() > deadline:
                    raise AssertionError("lifecycle: step %d was not served "
                                         "within 60 s" % new_step)
            reload_s = time.perf_counter() - renamed
        finally:
            client.close()
        new = load_checkpoint(path, Multiverse.init(cfg)).to(dev)
        new_trajs, new_logprobs = direct_forward(engine, cfg, probe, T,
                                                 params=new)
        diffs = {
            "before vs old": float(np.abs(before["logprobs"]
                                          - old_logprobs).max()),
            "after vs new": float(np.abs(got["logprobs"]
                                         - new_logprobs).max()),
            "after vs old": float(np.abs(got["logprobs"]
                                         - old_logprobs).max()),
            "after trajs vs new": float(np.abs(got["trajs"]
                                               - new_trajs).max())}
        print("lifecycle: step %d hot-reloaded %.3f s after its rename "
              "(the first response on the new weights; poll every %.1f s); "
              "max abs diffs of the beam log-probs (px for trajs): %s"
              % (new_step, reload_s, RELOAD_POLL_S, diffs))
        if not (diffs["before vs old"] <= 1e-3
                and diffs["after vs new"] <= 1e-3
                and diffs["after trajs vs new"] <= 1e-3
                and diffs["after vs old"] > 1e-3):
            raise AssertionError("lifecycle: the responses do not follow "
                                 "the served step's weights")
        launches["K3"] += serve_burst(
            engine, cfg, server, "lifecycle step %d (asyncio)" % new_step,
            obs, pred_lens, n_threads=4)

    with mock.patch.object(AsyncPredictionServer, "wait", drive):
        serve.main([outbase, "multiverse", "--port", "0", "--reload_poll_s",
                    str(RELOAD_POLL_S), *QUICKSTART_FLAGS])

    # the offline decode of the new step, as mvt-torch-multifuture-
    # inference loads its model_path, in the int8a tier
    cfg = flagship_config(decode_quant="int8a")
    model = inference_cli.load_model(save_dir, cfg)
    inputs = inference.synthesize_multifuture_inputs(cfg, 32, seed=2)
    T = int(inputs.pred_lengths.max())
    reset_launches()
    out, prob = inference.run_multifuture_inference(model, inputs, cfg,
                                                    batch_size=16, device=dev)
    torch.cuda.synchronize()
    k3 = decode_step_gathered_q8.launches["int8a"]
    if k3 != 2 * T:
        raise AssertionError(f"lifecycle offline: K3 ran {k3} steps, "
                             f"expected 2 x {T}")
    check_pickles(out, prob, inputs, cfg)
    launches["K3"] += k3
    timings = {}
    t0 = time.perf_counter()
    inference.run_multifuture_inference(model, inputs, cfg, batch_size=16,
                                        device=dev, timings=timings)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("lifecycle offline int8a (the reloaded step through the model_path "
          "load): %.2f traj/s (second run, %.3f s, 32 trajectories, T=%d, "
          "%d K3 launches in the first run); timings: build %.4f s, fetch "
          "%.4f s (%d bytes), pack %.4f s, %d batches"
          % (len(inputs.traj_ids) / dt, dt, T, k3, timings["build_s"],
             timings["fetch_s"], timings["fetch_bytes"], timings["pack_s"],
             timings["batches"]))
    return launches


def train_further(dev, tmp: str, save_dir: str, launches: dict):
    """RELOAD_STEPS train steps on the latest saved step (through K4/K5,
    whose launches are added to ``launches``), saved as the next step by
    ``CheckpointManager.save``. Returns the new step, its path and the
    host time of its rename."""
    cfg = train_config()
    latest = list_steps(save_dir)[-1][0]
    model = load_checkpoint(save_dir, Multiverse.init(cfg)).to(dev) \
        .requires_grad_(True)
    tx = trainer.build_optimizer(cfg, TRAIN_EXAMPLES)
    opt_state = tx.init(dict(model.named_parameters()))
    step = trainer.make_train_step(cfg, tx)
    ds = read_data(os.path.join(tmp, "prepro"), "train", cfg)
    gnn_dense_fwd.launches = gnn_dense_bwd.launches = 0
    for b in range(RELOAD_STEPS):
        batch, _ = ds.make_batch(list(range(b * cfg.batch_size,
                                            (b + 1) * cfg.batch_size)))
        loss = float(step(model, opt_state, batch_to_device(batch, dev),
                          rng=b)["total"])
        if not np.isfinite(loss):
            raise AssertionError(f"lifecycle: train loss {loss}")
    torch.cuda.synchronize()
    for k, fn in (("K4", gnn_dense_fwd), ("K5", gnn_dense_bwd)):
        if fn.launches != RELOAD_STEPS * cfg.pred_len:
            raise AssertionError(f"lifecycle: {k} ran {fn.launches} times "
                                 f"for {RELOAD_STEPS} steps")
        launches[k] += fn.launches
    renamed = []
    rename = os.rename

    def timed_rename(src, dst):
        rename(src, dst)
        renamed.append(time.perf_counter())

    new_step = latest + RELOAD_STEPS
    with mock.patch.object(os, "rename", timed_rename):
        path = CheckpointManager(os.path.dirname(save_dir)).save(new_step,
                                                                 model)
    if not (is_orbax_step(path) and written_by_port(path)):
        raise AssertionError(f"lifecycle: {path} is not an orbax step of "
                             "the port")
    print("lifecycle: %d more train steps on step %d (last loss %.4f) "
          "saved as %s, an orbax step of the port" % (RELOAD_STEPS, latest,
                                                       loss, path))
    return new_step, path, renamed[0]


# ---------------------------------------------------------- multi-device

# phase 9's gates: the 2-rank step against the single-process one (the
# train phase's kernel-vs-plain gates), the sharded beam decode's ids
# against the single-process decode's, with the log-probs of the beams
# that agree, and the 2-rank engine's answers against the 1-rank one's
# (phase 8's). The ids agreed in 1.0000 of beams, the log-probs exactly,
# on an NVIDIA H100 80GB HBM3 at 700 W; the share leaves room for bf16
# encoder convolutions that round differently at 8 rows than at 16,
# while a slice or gather in the wrong order agrees in a few beams
DP_BEAM_SAME_MIN = 0.99
DP_BEAM_LOGPROB_ATOL = 5e-3
DP_SERVE_ATOL = 1e-3
DP_UPDATE_RTOL = 2e-2
DP_WORLD = 2
DP_REQUESTS, DP_MAX_BATCH = 32, 8


def dp_train_batch(prepro: str, cfg):
    """The first batch_size train examples (a host Batch)."""
    return read_data(prepro, "train", cfg).make_batch(
        list(range(cfg.batch_size)))[0]


def dp_requests(cfg, seed: int = 9):
    rng = np.random.RandomState(seed)
    obs = [np.stack([rng.uniform(0, cfg.video_w, cfg.obs_len),
                     rng.uniform(0, cfg.video_h, cfg.obs_len)],
                    axis=1).astype(np.float32) for _ in range(DP_REQUESTS)]
    return obs, rng.randint(1, cfg.pred_len + 1, DP_REQUESTS)


def drive_engine(engine, obs, pred_lens) -> list:
    """The DP_REQUESTS requests submitted together, so that batches fill
    past the first rank's block; returns [(trajs, logprobs)] in request
    order."""
    handles = [engine.submit(o, pred_len=int(n))
               for o, n in zip(obs, pred_lens)]
    out = []
    for h in handles:
        if not h.event.wait(120):
            raise TimeoutError("multi-device: no answer within 120 s")
        if h.error is not None:
            raise h.error
        out.append((h.result.trajs, h.result.logprobs))
    return out


def numpy_named(model) -> dict:
    return {n: p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()}


def update_gap(before: dict, got: dict, want: dict) -> float:
    """The worst relative L2, over the parameters, of the update
    ``got - before`` against the update ``want - before``."""
    return max(float(np.linalg.norm((got[n] - before[n])
                                    - (want[n] - before[n])))
               / max(float(np.linalg.norm(want[n] - before[n])), 1e-30)
               for n in want)


def timed_steps(run_step, steps: int = 10, profiled: int = 3) -> dict:
    """Every rank: 2 warm-up steps, ``steps`` with one sync (steps/s),
    then ``profiled`` under torch.profiler (this rank's device busy time
    a step and the window a step)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run_step()
    torch.cuda.synchronize()
    steps_s = steps / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            run_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    return {"steps_s": steps_s, "busy_ms": device_busy_ms(prof) / profiled,
            "window_ms": window_ms / profiled}


def dp_rank(mesh, spec: dict) -> dict:
    """One rank of phase 9's 2-rank gloo group on cuda:0: the sharded
    train step (its gradients, one counted step, then timed steps), the
    sharded beam decode (K1) of the trained run, and a ServingEngine
    over the group (K3) across one update_params. Returns this rank's
    kernel launches and, on rank 0, what the parent checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the wall clock is shared by the processes: the first lap is the
    # spawn, the imports and the rendezvous
    out = {"rank": mesh.rank,
           "seconds": {"start": round(time.time() - spec["launched"], 3)}}
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["seconds"][what] = round(now - t0, 3)
        t0 = now

    cfg = train_config()
    shard = parallel.shard_batch(mesh, dp_train_batch(spec["prepro"], cfg))
    tx = trainer.build_optimizer(cfg, TRAIN_EXAMPLES)
    model, opt_state = parallel.init_sharded_train_state(
        load_checkpoint(spec["train_ckpt"], Multiverse.init(cfg)), tx, mesh)
    lap("set-up")
    grads, parts = parallel.sharded_loss_and_grads(model, shard, cfg, mesh)
    if mesh.is_main:
        out["loss"] = float(parts["total"])
        out["grads"] = {n: g.float().cpu().numpy() for n, g in grads.items()}
    del grads
    step = parallel.make_sharded_train_step(cfg, tx, mesh)
    calls = mesh.collectives
    reset_launches()
    step(model, opt_state, shard)
    torch.cuda.synchronize()
    out["K4"], out["K5"] = gnn_dense_fwd.launches, gnn_dense_bwd.launches
    out["step_collectives"] = mesh.collectives - calls
    if mesh.is_main:
        out["params"] = numpy_named(model)
    lap("gradients and one step")
    out["timing"] = timed_steps(lambda: step(model, opt_state, shard))
    del model, opt_state
    lap("15 timed steps")

    bcfg = flagship_config()
    bmodel = parallel.replicate(mesh, load_checkpoint(
        spec["beam_ckpt"], Multiverse.init(bcfg)))
    reset_launches()
    beam, _ = parallel.make_sharded_beam_step(bcfg, mesh)(
        bmodel, parallel.shard_batch(mesh, spec["beam_batch"]))
    torch.cuda.synchronize()
    out["K1"] = decode_step_gathered.launches
    if mesh.is_main:
        out["ids"] = beam.ids.cpu().numpy()
        out["logprobs"] = beam.logprobs.cpu().numpy()
    del bmodel, beam
    lap("beam decode")

    scfg = flagship_config(decode_quant="int8a")
    reset_launches()
    engine = ServingEngine(
        load_checkpoint(spec["serve_old"], Multiverse.init(scfg)), scfg,
        max_batch=DP_MAX_BATCH, T_pred=scfg.pred_len, mesh=mesh)
    if not mesh.is_main:
        engine.run_worker()
        lap("serving")
        out["K3"] = decode_step_gathered_q8.launches["int8a"]
        out["ended"] = time.time()
        return out
    try:
        engine.warmup()
        obs, pred_lens = dp_requests(scfg)
        out["before"] = drive_engine(engine, obs, pred_lens)
        out["stats_before"] = engine.stats.snapshot()
        engine.update_params(read_checkpoint_tree(spec["serve_new"]))
        engine.stats.reset()
        out["after"] = drive_engine(engine, obs, pred_lens)
        out["stats_after"] = engine.stats.snapshot()
    finally:
        engine.close()
    lap("serving")
    out["K3"] = decode_step_gathered_q8.launches["int8a"]
    out["ended"] = time.time()
    return out


@contextlib.contextmanager
def nccl_group_of_one(mesh):
    """``mesh`` (world 1) in an NCCL group of one in this process.
    ``launch`` gives world 1 no group; this one drives the sharded
    step's collectives through NCCL on a one-card machine and reads
    what a group would cost there."""
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield dataclasses.replace(mesh, group=dist.group.WORLD,
                                  data_group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def dp_throughput_rank(mesh, spec: dict) -> dict:
    """One rank of the NCCL group over every visible GPU: the sharded
    train step's buffered steps/s and all-reduces a step, and the
    single-process step's on the same weights and the rank's shard,
    alternated (sharded, single, sharded, single) so that the host's
    drift within the call falls on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config()
    shard = parallel.shard_batch(mesh, dp_train_batch(spec["prepro"], cfg))
    tx = trainer.build_optimizer(cfg, TRAIN_EXAMPLES)
    model, opt_state = parallel.init_sharded_train_state(
        load_checkpoint(spec["train_ckpt"], Multiverse.init(cfg)), tx, mesh)
    step = parallel.make_sharded_train_step(cfg, tx, mesh)
    single = trainer.make_train_step(cfg, tx)
    calls = mesh.collectives
    step(model, opt_state, shard)
    out = {"step_collectives": mesh.collectives - calls,
           "backend": mesh.backend, "sharded": [], "single": []}
    for _ in range(2):
        out["sharded"].append(timed_steps(
            lambda: step(model, opt_state, shard)))
        out["single"].append(timed_steps(
            lambda: single(model, opt_state, shard)))
    return out


def beam_agreement(got_ids, got_lp, want_ids, want_lp, lengths) -> tuple:
    """Share of (trajectory, beam) whose ids agree up to the trajectory's
    pred_length, and the largest log-prob difference among them."""
    same = np.stack([(got_ids[n, :, :t] == want_ids[n, :, :t]).all(-1)
                     for n, t in enumerate(lengths)])
    lp = np.abs(got_lp - want_lp)[same]
    return float(same.mean()), float(lp.max()) if lp.size else 0.0


def max_answer_diff(got: list, want: list) -> float:
    return max(max(float(np.abs(a[0] - b[0]).max()),
                   float(np.abs(a[1] - b[1]).max()))
               for a, b in zip(got, want))


def multi_device_phase(dev, tmp: str, single_step: dict) -> dict:
    """Phase 9 (see the module docstring). ``single_step`` is the train
    phase's single-process steps/s and idle share. Returns the launches
    of K1, K3, K4 and K5 on the phase's paths (every rank's)."""
    prepro = os.path.join(tmp, "prepro")
    save_dir = os.path.join(tmp, "out", "multiverse", "00", "save")
    steps = list_steps(save_dir)
    cfg = train_config()
    bcfg = flagship_config()
    inputs = inference.synthesize_multifuture_inputs(bcfg, 16, seed=5)
    spec = {"prepro": prepro, "train_ckpt": steps[-1][1],
            "beam_ckpt": steps[-1][1], "serve_old": steps[-2][1],
            "serve_new": steps[-1][1],
            "beam_batch": inference.make_batch(inputs, np.arange(16), bcfg)}
    launches = {"K1": 0, "K3": 0, "K4": 0, "K5": 0}

    # 1.-3. the 2-rank gloo group on one card
    t0 = time.perf_counter()
    mesh = parallel.make_mesh(devices=["cuda:0"] * DP_WORLD)
    spec["launched"] = time.time()
    ranks = parallel.launch(dp_rank, mesh, spec, timeout=300)
    wall = time.perf_counter() - t0
    for r in ranks:
        r["seconds"]["exit and results"] = round(time.time() - r["ended"],
                                                 3)
    main = ranks[0]
    for r in ranks:
        for k in launches:
            launches[k] += r[k]
        if (r["K4"], r["K5"], r["K1"]) != (cfg.pred_len, cfg.pred_len,
                                           bcfg.pred_len) \
                or r["K3"] != main["K3"] or not r["K3"]:
            raise AssertionError(
                "multi-device: rank %d ran K4/K5 %d/%d times in one step "
                "(expected %d each), K1 %d times in the decode (expected "
                "%d), K3 %d times serving (rank 0: %d)"
                % (r["rank"], r["K4"], r["K5"], cfg.pred_len, r["K1"],
                   bcfg.pred_len, r["K3"], main["K3"]))
    print("multi-device: %d gloo ranks on cuda:0, %.1f s (seconds by part "
          "and rank: %s); K4/K5 a rank a step %s; all-reduces a step %d"
          % (DP_WORLD, wall, [r["seconds"] for r in ranks],
             [(r["K4"], r["K5"]) for r in ranks], main["step_collectives"]))

    model = load_checkpoint(spec["train_ckpt"], Multiverse.init(cfg)) \
        .to(dev).requires_grad_(True)
    batch = batch_to_device(dp_train_batch(prepro, cfg), dev)
    grads_p, parts_p = trainer.loss_and_grads(model, batch, cfg)
    compare_step("multi-device 2-rank step vs single-process",
                 {n: torch.from_numpy(g) for n, g in main["grads"].items()},
                 main["loss"], {n: g.float().cpu()
                                for n, g in grads_p.items()},
                 float(parts_p["total"]))
    tx = trainer.build_optimizer(cfg, TRAIN_EXAMPLES)
    before = numpy_named(model)
    tx.update(dict(model.named_parameters()), grads_p,
              tx.init(dict(model.named_parameters())))
    after = numpy_named(model)
    worst = max(float(np.linalg.norm(main["params"][n] - want))
                / max(float(np.linalg.norm(want)), 1e-30)
                for n, want in after.items())
    # one step moves the weights far less than 2e-2 of their norm, so
    # the update itself is held too: a step that left the parameters
    # unchanged reads 1 there
    worst_update = update_gap(before, main["params"], after)
    unchanged = update_gap(before, before, after)
    print("multi-device: updated parameters vs the single-process step's: "
          "worst relative L2 %.3g (gate %.0e); of the update itself %.3g "
          "(gate %.0e; unchanged parameters would read %.3g)"
          % (worst, DP_UPDATE_RTOL, worst_update, DP_UPDATE_RTOL,
             unchanged))
    if not (worst <= DP_UPDATE_RTOL and worst_update <= DP_UPDATE_RTOL
            and unchanged > DP_UPDATE_RTOL):
        raise AssertionError("multi-device: the 2-rank step's update "
                             "disagrees with the single-process step's")
    del model, grads_p
    busy = [r["timing"]["busy_ms"] for r in ranks]
    window = main["timing"]["window_ms"]
    print("multi-device: 2-rank step on one card (two ranks time-share the "
          "card: not a scaling figure): %.2f steps/s, %.1f examples/s; "
          "device busy a step %s ms by rank, window %.2f ms a step, card "
          "idle share %.4f; single-process (train phase) %.2f steps/s, "
          "idle %.4f"
          % (main["timing"]["steps_s"], main["timing"]["steps_s"]
             * cfg.batch_size, [round(b, 3) for b in busy], window,
             1 - sum(busy) / window, single_step["steps_s"],
             single_step["idle"]))

    bmodel = load_checkpoint(spec["beam_ckpt"], Multiverse.init(bcfg)) \
        .to(dev)
    with torch.inference_mode():
        beam1, _ = inference.beam_forward(
            bmodel, batch_to_device(spec["beam_batch"], dev), bcfg)
    same, lp = beam_agreement(main["ids"], main["logprobs"],
                              beam1.ids.cpu().numpy(),
                              beam1.logprobs.cpu().numpy(),
                              spec["beam_batch"].pred_length)
    print("multi-device: 2-rank sharded beam decode (bf16, K1, 16 "
          "trajectories of the trained run, K = 20) vs single-process: "
          "beam ids agree in %.4f of beams (gate %.2f), log-probs of those "
          "within %.3g (gate %.0e); K1 launches by rank %s"
          % (same, DP_BEAM_SAME_MIN, lp, DP_BEAM_LOGPROB_ATOL,
             [r["K1"] for r in ranks]))
    if not (same >= DP_BEAM_SAME_MIN and lp <= DP_BEAM_LOGPROB_ATOL):
        raise AssertionError("multi-device: the sharded beam decode "
                             "disagrees with the single-process one")
    del bmodel, beam1

    scfg = flagship_config(decode_quant="int8a")
    obs, pred_lens = dp_requests(scfg)
    want = {}
    for key in ("serve_old", "serve_new"):
        engine = ServingEngine(load_checkpoint(spec[key],
                                               Multiverse.init(scfg)),
                               scfg, max_batch=DP_MAX_BATCH,
                               T_pred=scfg.pred_len, device=dev)
        try:
            engine.warmup()
            want[key] = drive_engine(engine, obs, pred_lens)
            want[key + "_stats"] = engine.stats.snapshot()
        finally:
            engine.close()
    diffs = (max_answer_diff(main["before"], want["serve_old"]),
             max_answer_diff(main["after"], want["serve_new"]),
             max_answer_diff(main["after"], want["serve_old"]))
    largest = (main["stats_before"]["largest_batch"],
               main["stats_after"]["largest_batch"])
    print("multi-device: ServingEngine over 2 gloo ranks on cuda:0 (bf16 + "
          "int8a, max_batch %d, K = 20, %d requests submitted together, "
          "before and after update_params): largest batch %d / %d requests "
          "(rank 1 decodes rows %d-%d); max abs diff vs the 1-rank engine "
          "%.3g / %.3g (gate %.0e), after vs the old weights %.3g; p50 %s "
          "/ %s ms, max %s / %s ms (1 rank: p50 %s / %s ms); K3 launches "
          "by rank %s"
          % (DP_MAX_BATCH, DP_REQUESTS, largest[0], largest[1],
             DP_MAX_BATCH // 2, DP_MAX_BATCH - 1, diffs[0], diffs[1],
             DP_SERVE_ATOL, diffs[2],
             main["stats_before"].get("p50_latency_ms"),
             main["stats_after"].get("p50_latency_ms"),
             main["stats_before"]["max_latency_ms"],
             main["stats_after"]["max_latency_ms"],
             want["serve_old_stats"].get("p50_latency_ms"),
             want["serve_new_stats"].get("p50_latency_ms"),
             [r["K3"] for r in ranks]))
    if not (diffs[0] <= DP_SERVE_ATOL and diffs[1] <= DP_SERVE_ATOL
            and diffs[2] > DP_SERVE_ATOL
            and main["stats_before"]["errors"] == 0
            and main["stats_after"]["errors"] == 0):
        raise AssertionError("multi-device: the 2-rank engine's answers "
                             "differ from the 1-rank engine's")
    if not min(largest) > DP_MAX_BATCH // 2:
        raise AssertionError("multi-device: no served batch reached rank "
                             "1's rows, so its answers went unchecked")

    # mvt-torch-serve refuses more devices than are visible
    n = torch.cuda.device_count() + 1
    try:
        serve.main(["out", "model", "--random_init", "--num_devices", str(n)])
    except SystemExit as exc:
        if f"expected {n} devices, found {n - 1}" not in str(exc):
            raise
        print("multi-device: mvt-torch-serve --num_devices %d: %s"
              % (n, exc))
    else:
        raise AssertionError("mvt-torch-serve served on fewer devices "
                             "than --num_devices")

    # 2. NCCL over every visible GPU: mvt-torch-train's main, then the
    # sharded step's throughput at that world (at world 1, where the
    # command forms no group, in an NCCL group of one)
    gpus = parallel.make_mesh_for_batch(cfg.batch_size)
    world = gpus.world
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--num_epochs") + 1] = "1"
    reset_launches()
    t0 = time.perf_counter()
    summary = train_cli.main([prepro, os.path.join(tmp, "out_dp"), "dp",
                              *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = TRAIN_EXAMPLES // cfg.batch_size
    eval_batches = -(-VAL_EXAMPLES // cfg.batch_size)
    if summary["world"] != world or summary["steps"] != n_steps \
            or (summary["collectives"] == 0) != (world == 1):
        raise AssertionError(f"multi-device: mvt-torch-train ran "
                             f"{summary['steps']} steps at world "
                             f"{summary['world']} with "
                             f"{summary['collectives']} collectives")
    if world == 1:    # in this process: its launches are counted here
        if (gnn_dense_fwd.launches, gnn_dense_bwd.launches,
                decode_step_gathered.launches) != (
                n_steps * cfg.pred_len, n_steps * cfg.pred_len,
                eval_batches * cfg.pred_len):
            raise AssertionError("multi-device: mvt-torch-train's K4/K5/K1 "
                                 "launches do not match its steps")
        launches["K4"] += gnn_dense_fwd.launches
        launches["K5"] += gnn_dense_bwd.launches
        launches["K1"] += decode_step_gathered.launches
    if world > 1:
        nccl = parallel.launch(dp_throughput_rank, gpus, spec,
                               timeout=300)[0]
    else:
        with nccl_group_of_one(gpus) as mesh:
            nccl = dp_throughput_rank(mesh, spec)

    def readings(key):
        return ", ".join("%.2f steps/s (idle %.4f)" % (
            t["steps_s"], 1 - t["busy_ms"] / t["window_ms"])
            for t in nccl[key])

    print("multi-device: mvt-torch-train's main over every visible GPU: "
          "world %d, %d steps and one eval in %.2f s, %d collectives; in "
          "an %s group of that world (%d all-reduces a step), on rank 0's "
          "shard (batch %d), alternated: the sharded step %s; the "
          "single-process step %s (the train phase's %.2f steps/s, idle "
          "%.4f)"
          % (world, n_steps, wall, summary["collectives"], nccl["backend"],
             nccl["step_collectives"], cfg.batch_size // world,
             readings("sharded"), readings("single"),
             single_step["steps_s"], single_step["idle"]))
    return launches


# ------------------------------------------------------ tensor parallelism

# phase 11: two ranks share cuda:0 at dp 1 x mp 2, TP_STEPS steps on one
# batch of TP_EXAMPLES generated examples from the trained run's newest
# step, then mvt-torch-train --model_parallel 2 over the same examples
# for TP_STEPS epochs; the 4-rank grid (dp 2 x mp 2) takes one step
TP_MP, TP_STEPS, TP_EXAMPLES = 2, 3, 20
# mvt-torch-test's flags for that run (TRAIN_FLAGS' model flags)
TP_TEST_FLAGS = ["--batch_size", "20", "--use_gnn", "--use_scene_enc",
                 "--use_soft_grid_class", "--soft_grid", "1",
                 "--scene_grid_strides", "2,4", "--use_grids", "1,0",
                 "--compute_dtype", "bfloat16", "--device", "cuda:0"]


def tp_state_bytes(model, opt_state) -> int:
    """Bytes of a rank's parameters and optimizer slots."""
    slots = [t for v in opt_state.values() if isinstance(v, dict)
             for t in v.values()]
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + slots)


def tp_rank(mesh, spec: dict) -> dict:
    """One rank of phase 11's gloo ranks on cuda:0: ``spec["steps"]``
    tensor-parallel train steps on the rank's data block (K4/K5 counted,
    the model group's collectives of one step), the gathered whole
    weights, the rank's bytes of weights and slots; with ``timed``,
    timed steps and one sharded eval (K1). Returns what the parent
    checks (the whole weights on rank 0 only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config()
    shard = parallel.shard_batch(mesh, dp_train_batch(spec["prepro"], cfg))
    # the schedule mvt-torch-train makes for TP_EXAMPLES examples
    tx = trainer.build_optimizer(cfg, TP_EXAMPLES)
    model, opt_state = parallel.init_sharded_train_state(
        load_checkpoint(spec["ckpt"], Multiverse.init(cfg)), tx, mesh)
    out = {"rank": mesh.rank, "state_bytes": tp_state_bytes(model, opt_state),
           "sharded": sum(getattr(p, "shard", None) is not None
                          for p in model.parameters()),
           "leaves": len(list(model.parameters())), "losses": []}
    step = parallel.make_sharded_train_step(cfg, tx, mesh)
    reset_launches()
    for i in range(spec["steps"]):
        calls, nbytes = mesh.model_collectives, mesh.model_bytes
        out["losses"].append(float(step(model, opt_state, shard)["total"]))
        if i == 0:
            out["step_collectives"] = mesh.model_collectives - calls
            out["step_bytes"] = mesh.model_bytes - nbytes
    torch.cuda.synchronize()
    out["K4"], out["K5"] = gnn_dense_fwd.launches, gnn_dense_bwd.launches
    whole = parallel.gather_params(mesh, model)
    if mesh.is_main:
        out["params"] = numpy_named(whole)
    if not spec["timed"]:
        return out
    out["timing"] = timed_steps(lambda: step(model, opt_state, shard),
                                steps=4, profiled=2)
    reset_launches()
    whole = parallel.gather_params(mesh, model)
    val = read_data(spec["prepro"], "val", cfg).make_batch(
        list(range(cfg.batch_size)))[0]
    parallel.make_sharded_eval_step(cfg, mesh)(
        whole, parallel.shard_batch(mesh, val))
    torch.cuda.synchronize()
    out["K1"] = decode_step_gathered.launches
    return out


def tp_train_cli_rank(mesh, argv: list) -> dict:
    """``mvt-torch-train``'s rank worker, recording the whole weights
    each save gathers; returns its summary and, on rank 0, the last
    gathered weights."""
    gathered = []

    def gather(m, model):
        whole = parallel.gather_params(m, model)
        gathered.append(whole)
        return whole

    args = train_cli.build_parser().parse_args(argv)
    with mock.patch.object(train_cli, "gather_params", gather):
        summary = train_cli.train_worker(mesh, args)
    if mesh.is_main:
        summary["params"] = numpy_named(gathered[-1])
    summary.update(rank=mesh.rank, K4=gnn_dense_fwd.launches,
                   K5=gnn_dense_bwd.launches,
                   K1=decode_step_gathered.launches)
    return summary


def tp_gap(what: str, got: dict, want: dict, before: dict) -> float:
    """The worst relative L2 of ``got`` against ``want`` over the
    parameters and of the update from ``before``; fails above
    DP_UPDATE_RTOL, or where the update check cannot tell a step from
    none."""
    worst = max(float(np.linalg.norm(got[n] - w))
                / max(float(np.linalg.norm(w)), 1e-30)
                for n, w in want.items())
    worst_update = update_gap(before, got, want)
    unchanged = update_gap(before, before, want)
    by_leaf = sorted(((update_gap(before, got, {n: w}), n)
                      for n, w in want.items()), reverse=True)[:3]
    print("tensor-parallel: %s: worst relative L2 of the whole parameters "
          "%.3g, of the update %.3g (gate %.0e; unchanged parameters would "
          "read %.3g; the update's worst leaves %s)"
          % (what, worst, worst_update, DP_UPDATE_RTOL, unchanged,
             ", ".join("%s %.3g" % (n, g) for g, n in by_leaf)))
    if not (worst <= DP_UPDATE_RTOL and worst_update <= DP_UPDATE_RTOL
            and unchanged > DP_UPDATE_RTOL):
        raise AssertionError(f"tensor-parallel: {what}: the update "
                             f"disagrees with the single-process one")
    return worst


def tensor_parallel_phase(dev, tmp: str, card: str) -> dict:
    """Phase 11 (see the module docstring). Returns the launches of K1,
    K4 and K5 on its paths (every rank's)."""
    cfg = train_config()
    prepro = synthesize_prepro(os.path.join(tmp, "tp_prepro"), cfg,
                               n_train=TP_EXAMPLES, n_val=cfg.batch_size,
                               seed=11)
    # mvt-torch-test reads a test split: the val examples
    shutil.copy(os.path.join(prepro, "data_val.npz"),
                os.path.join(prepro, "data_test.npz"))
    ckpt = list_steps(os.path.join(tmp, "out", "multiverse", "00",
                                   "save"))[-1][1]
    spec = {"prepro": prepro, "ckpt": ckpt, "steps": TP_STEPS,
            "timed": True}
    launches = {"K1": 0, "K4": 0, "K5": 0}

    # the single process: the same weights, batch and steps
    model = load_checkpoint(ckpt, Multiverse.init(cfg)).to(dev) \
        .requires_grad_(True)
    batch = batch_to_device(dp_train_batch(prepro, cfg), dev)
    tx = trainer.build_optimizer(cfg, TP_EXAMPLES)
    opt_state = tx.init(dict(model.named_parameters()))
    single_bytes = tp_state_bytes(model, opt_state)
    before = numpy_named(model)
    step = trainer.make_train_step(cfg, tx)
    single_losses, after = [], []
    for _ in range(TP_STEPS):
        single_losses.append(float(step(model, opt_state, batch)["total"]))
        after.append(numpy_named(model))
    single = timed_steps(lambda: step(model, opt_state, batch))
    del model, opt_state

    # (a)-(d): dp 1 x mp 2 on cuda:0
    t0 = time.perf_counter()
    mesh = parallel.make_mesh(devices=["cuda:0"] * TP_MP,
                              model_parallel=TP_MP)
    ranks = parallel.launch(tp_rank, mesh, spec, timeout=400)
    wall = time.perf_counter() - t0
    main = ranks[0]
    for r in ranks:
        for k in launches:
            launches[k] += r[k]
        if (r["K4"], r["K5"], r["K1"]) != (TP_STEPS * cfg.pred_len,
                                           TP_STEPS * cfg.pred_len,
                                           cfg.pred_len):
            raise AssertionError(
                "tensor-parallel: rank %d ran K4/K5 %d/%d times in %d "
                "steps (expected %d each) and K1 %d times in one eval "
                "(expected %d)" % (r["rank"], r["K4"], r["K5"], TP_STEPS,
                                   TP_STEPS * cfg.pred_len, r["K1"],
                                   cfg.pred_len))
        if r["losses"] != main["losses"]:
            raise AssertionError("tensor-parallel: the model ranks' losses "
                                 "differ: %s" % [x["losses"] for x in ranks])
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(main["losses"], single_losses))
    print("tensor-parallel: %d gloo ranks on cuda:0 at dp 1 x mp %d, %.1f s "
          "(%s); %d steps on one batch of %d from the trained step: losses "
          "%s vs the single process's %s (worst relative gap %.3g, gate "
          "%.0e); K4/K5 launches by rank %s, eval K1 by rank %s"
          % (TP_MP, TP_MP, wall, card, TP_STEPS, cfg.batch_size,
             [round(x, 5) for x in main["losses"]],
             [round(x, 5) for x in single_losses], loss_gap, DP_UPDATE_RTOL,
             [(r["K4"], r["K5"]) for r in ranks], [r["K1"] for r in ranks]))
    if not loss_gap <= DP_UPDATE_RTOL:
        raise AssertionError("tensor-parallel: the losses disagree with the "
                             "single process's")
    tp_gap("dp 1 x mp 2, %d steps, vs the single process" % TP_STEPS,
           main["params"], after[-1], before)
    print("tensor-parallel: weights + optimizer slots by rank %s bytes, the "
          "single process %d bytes (%s of it a rank); %d of %d leaves "
          "sharded (%s)"
          % ([r["state_bytes"] for r in ranks], single_bytes,
             ["%.4f" % (r["state_bytes"] / single_bytes) for r in ranks],
             main["sharded"], main["leaves"], card))
    busy = [r["timing"]["busy_ms"] for r in ranks]
    window = main["timing"]["window_ms"]
    print("tensor-parallel: dp 1 x mp 2 on one card (%s; two ranks "
          "time-share it: not a scaling figure): %.2f steps/s, device busy "
          "a step %s ms by rank, window %.2f ms a step, card idle share "
          "%.4f; the single process %.2f steps/s, busy %.2f ms, idle %.4f; "
          "model-group all-reduces a step %d moving %d bytes (%.2f MB)"
          % (card, main["timing"]["steps_s"], [round(b, 3) for b in busy],
             window, 1 - sum(busy) / window, single["steps_s"],
             single["busy_ms"],
             1 - single["busy_ms"] / single["window_ms"],
             main["step_collectives"], main["step_bytes"],
             main["step_bytes"] / 1e6))

    # the data 2 x model 2 grid, four ranks on the card: one step
    spec4 = dict(spec, steps=1, timed=False)
    t0 = time.perf_counter()
    grid = parallel.launch(tp_rank, parallel.make_mesh(
        devices=["cuda:0"] * 4, model_parallel=TP_MP), spec4, timeout=400)
    for r in grid:
        launches["K4"] += r["K4"]
        launches["K5"] += r["K5"]
        if (r["K4"], r["K5"]) != (cfg.pred_len, cfg.pred_len):
            raise AssertionError("tensor-parallel: dp 2 x mp 2 rank %d ran "
                                 "K4/K5 %d/%d times in one step"
                                 % (r["rank"], r["K4"], r["K5"]))
    print("tensor-parallel: dp 2 x mp 2, four gloo ranks on cuda:0, one "
          "step in %.1f s; loss %.5f vs %.5f; K4/K5 by rank %s"
          % (time.perf_counter() - t0, grid[0]["losses"][0],
             single_losses[0], [(r["K4"], r["K5"]) for r in grid]))
    tp_gap("dp 2 x mp 2, one step, vs the single process",
           grid[0]["params"], after[0], before)

    # (e) mvt-torch-train --model_parallel 2 from the same step over the
    # same 20 examples (one batch an epoch), then mvt-torch-test
    out = os.path.join(tmp, "out_tp")
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--num_epochs") + 1] = str(TP_STEPS)
    flags[flags.index("--save_period") + 1] = str(TP_STEPS)
    argv = [prepro, out, "tp", *flags, "--model_parallel", str(TP_MP),
            "--load_from", ckpt]
    t0 = time.perf_counter()
    runs = parallel.launch(tp_train_cli_rank, mesh, argv, timeout=400)
    wall = time.perf_counter() - t0
    for r in runs:
        launches["K4"] += r["K4"]
        launches["K5"] += r["K5"]
        launches["K1"] += r["K1"]
        if r["steps"] != TP_STEPS or r["world"] != TP_MP or not r["K4"]:
            raise AssertionError(f"tensor-parallel: mvt-torch-train rank "
                                 f"{r['rank']}: {r['steps']} steps at world "
                                 f"{r['world']}, K4 {r['K4']}")
    saved = list_steps(os.path.join(out, "tp", "00", "save"))
    reset_launches()
    perf = test_cli.main([prepro, out, "tp", *TP_TEST_FLAGS])
    torch.cuda.synchronize()
    launches["K1"] += decode_step_gathered.launches
    loaded = numpy_named(load_checkpoint(saved[-1][1], Multiverse.init(cfg)))
    exact = all(np.array_equal(loaded[n], v)
                for n, v in runs[0]["params"].items())
    print("tensor-parallel: mvt-torch-train --model_parallel %d: %d steps "
          "and evals in %.1f s, steps saved %s, K4/K5/K1 by rank %s; the "
          "saved step equals the weights it gathered: %s; mvt-torch-test "
          "in one process on it: %s=%.4f, K1 %d"
          % (TP_MP, TP_STEPS, wall, [s for s, _ in saved],
             [(r["K4"], r["K5"], r["K1"]) for r in runs], exact,
             "grid0_traj_ade", perf["grid0_traj_ade"],
             decode_step_gathered.launches))
    if saved[-1][0] != TP_STEPS or not exact:
        raise AssertionError("tensor-parallel: mvt-torch-train's saved step "
                             "is not the whole weights it gathered")
    tp_gap("mvt-torch-train --model_parallel 2's saved step vs (a)'s "
           "gathered weights", loaded, main["params"], before)
    return launches


# ---------------------------------------------------------------- SimAug


def simaug_config(flags=SIMAUG_FLAGS) -> SimAugConfig:
    """The configuration ``mvt-torch-train-simaug`` makes of ``flags``."""
    return simaug_cli.simaug_config_from_args(
        simaug_cli.build_parser().parse_args(["prepro", "out", "m",
                                              *flags]))


def attack_agreement(model, cfg, batch) -> None:
    """One multiview attack step (``_attack_step_with_loss``, and the
    input gradient it signs) at N*M rows through K4/K5 and through their
    plain versions, on the same weights, batch and draws at keep_prob 1:
    the per-example CE within 1e-2 relative, the input gradient within
    2e-2 relative L2; prints the share of stepped features that
    differ."""
    cfg = cfg.replace(keep_prob=1.0)
    params = simaug._detached(model)
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    N, M = batch.pred_grid_class_extra.shape[:2]
    scene = simaug.scene_input_of(batch, cfg)
    draws = simaug.multiview_draws(cfg, simaug.StepRng(11, scene.device),
                                   scene.shape, M)
    start = scene.repeat_interleave(M, dim=0) + draws.noise
    eps = cfg.adv_epsilon
    lower = torch.clamp(start - eps, -1.0, 1.0)
    upper = torch.clamp(start + eps, -1.0, 1.0)
    onehot = one_hot_grid(batch.obs_grid_class[:, i], h, w) \
        .repeat_interleave(M, dim=0)
    target = batch.pred_grid_class_extra.reshape(N * M, -1)

    def run():
        grad, _ = simaug._input_grad(params, start, onehot, target, cfg)
        stepped, ce = simaug._attack_step_with_loss(
            params, start, onehot, target, cfg, eps, lower, upper)
        return grad, ce, stepped

    before = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    grad_k, ce_k, stepped_k = run()
    torch.cuda.synchronize()
    ran = (gnn_dense_fwd.launches - before[0],
           gnn_dense_bwd.launches - before[1])
    with plain_gnn():
        grad_p, ce_p, stepped_p = run()
    ce_rel = float(((ce_k - ce_p).abs() / ce_p.abs()).max())
    grad_rel = float((grad_k - grad_p).norm() / grad_p.norm())
    differ = float((stepped_k != stepped_p).float().mean())
    print("simaug phase: attack step at %d rows (N=%d x M=%d), kernel vs "
          "plain: per-example CE max rel %.3g (limit 1e-2), input gradient "
          "rel L2 %.4g (limit 2e-2), |grad| max %.4g; stepped features "
          "differing %.6f; K4/K5 launches %s (2 passes x %d)"
          % (N * M, N, M, ce_rel, grad_rel, float(grad_p.abs().max()),
             differ, ran, cfg.pred_len))
    if ran != (2 * cfg.pred_len,) * 2:
        raise AssertionError(f"simaug phase: the attack step ran K4/K5 "
                             f"{ran} times")
    if not ce_rel <= 1e-2 or not grad_rel <= 2e-2:
        raise AssertionError("simaug phase: the attack step through K4/K5 "
                             "disagrees with the plain one")


def outer_agreement(model, cfg, batch) -> None:
    """One outer SimAug step on one augmented batch (the augmentation
    made once, through the kernels), its loss and gradients through
    K4/K5 and through their plain versions."""
    draws = simaug.step_draws(cfg, batch, 21)
    scene, onehot, mix = simaug.augment(model, batch, cfg, draws)

    def loss_and_grads():
        total, _ = simaug.tower_loss(model, batch, cfg, scene, onehot, mix,
                                     draws.dropout)
        return trainer.gradients(model, total), float(total.detach())

    grads_k, loss_k = loss_and_grads()
    with plain_gnn():
        grads_p, loss_p = loss_and_grads()
    compare_step("simaug phase", grads_k, loss_k, grads_p, loss_p)


def simaug_gnn_shapes(model, flagship, dev) -> None:
    """Phase 7's kernel part: the training-kernel phase at SimAug's
    shapes, the multiview attack's N*M samples and the outer step's N,
    gates and planted faults included."""
    cfg = simaug_config()
    for n in (cfg.batch_size * cfg.multiview_max_num, cfg.batch_size):
        gnn_kernel_phase(model, flagship, dev, N=n)


def simaug_phase(model, dev) -> dict:
    """SimAug on the card: the attack's input gradient and an outer
    step through K4/K5 against their plain versions,
    mvt-torch-train-simaug end to end with TRAINING.md's published flags,
    and the multiview and PGD-30 steps' throughput. Returns the launches
    of K4, K5 and the evals' K1 in the command's run."""
    cfg = simaug_config()
    with tempfile.TemporaryDirectory() as tmp:
        prepro = synthesize_multiview_prepro(
            os.path.join(tmp, "prepro"), cfg, SIMAUG_AGENTS, SIMAUG_VAL,
            seed=0)
        ds = MultiviewDataset(read_data(prepro, "train", cfg), cfg,
                              cfg.multiview_max_num)
        batch = batch_to_device(
            ds.make_batch(list(range(cfg.batch_size)))[0], dev)
        attack_agreement(model, cfg, batch)

        rec = StepRecorder(simaug.make_simaug_train_step)
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(simaug_cli, "make_simaug_train_step", rec):
            simaug_cli.main([prepro, os.path.join(tmp, "out"), "simaug",
                             *SIMAUG_FLAGS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(rec.losses)
        losses = torch.stack(rec.losses).cpu().numpy()
        launches = {"K4": gnn_dense_fwd.launches,
                    "K5": gnn_dense_bwd.launches,
                    "K1": decode_step_gathered.launches}
        run = os.path.join(tmp, "out", "simaug", "00")
        with open(os.path.join(run, "val_perf.json")) as f:
            best_step = json.load(f)["best"]["step"]
        num_examples = SIMAUG_AGENTS * 4
        want_steps = -(-num_examples // cfg.batch_size) * cfg.num_epochs
        evals = -(-want_steps // SIMAUG_SAVE_PERIOD)
        eval_batches = evals * -(-SIMAUG_VAL // cfg.batch_size)
        # every step: the attack's tower pass and the outer one, each
        # with one K4 and one K5 a decode step
        want_gnn = steps * cfg.pred_len * 2
        print("simaug phase: mvt-torch-train-simaug %d steps in %.3f s "
              "(main, evals and saves included); first loss %.4f, last 5 "
              "mean %.4f; launches K4 %d, K5 %d (steps x %d x 2 = %d), "
              "eval K1 %d (%d evals x %d batches x %d)"
              % (steps, wall, losses[0], losses[-5:].mean(),
                 launches["K4"], launches["K5"], cfg.pred_len, want_gnn,
                 launches["K1"], evals, eval_batches // evals,
                 cfg.pred_len))
        if steps != want_steps or not np.isfinite(losses).all():
            raise AssertionError(f"simaug phase: {steps} steps, losses "
                                 f"finite: {np.isfinite(losses).all()}")
        if launches["K4"] != want_gnn or launches["K5"] != want_gnn:
            raise AssertionError(f"simaug phase: K4/K5 ran {launches['K4']}/"
                                 f"{launches['K5']} times, not {want_gnn}")
        if launches["K1"] != eval_batches * cfg.pred_len:
            raise AssertionError(f"simaug phase: the evals' K1 ran "
                                 f"{launches['K1']} times for "
                                 f"{eval_batches} batches x {cfg.pred_len}")
        trained = best_checkpoint_decodes("simaug phase", run, best_step,
                                          cfg, dev)
    trained = trained.to(dev).requires_grad_(True)
    outer_agreement(trained, cfg, batch)

    tx = trainer.build_optimizer(cfg, num_examples)
    opt_state = tx.init(dict(trained.named_parameters()))
    step = simaug.make_simaug_train_step(cfg, tx)
    seeds = iter(range(1000, 2000))
    step_throughput(
        "simaug phase (multiview step)",
        lambda: step(trained, opt_state, batch, next(seeds)), cfg.batch_size)

    pgd = simaug_config(PGD_FLAGS)
    pgd_step = simaug.make_simaug_train_step(pgd, tx)
    pgd_step(trained, opt_state, batch, 0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for k in range(3):
        pgd_step(trained, opt_state, batch, k + 1)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / 3
    ran = (gnn_dense_fwd.launches, gnn_dense_bwd.launches)
    want = 3 * (pgd.adv_num_iter + 1) * pgd.pred_len
    print("simaug phase: PGD-%d step at batch %d: %.4f s a step (3 steps, "
          "one sync); K4/K5 launches %s, %d x %d a step"
          % (pgd.adv_num_iter, pgd.batch_size, per_step, ran,
             pgd.adv_num_iter + 1, pgd.pred_len))
    if ran != (want, want):
        raise AssertionError(f"simaug phase: the PGD step ran K4/K5 {ran} "
                             f"times, not {want}")
    return launches


def best_checkpoint_decodes(what: str, run: str, best_step: int, cfg,
                            dev) -> Multiverse:
    """Both checkpoint directories of a training run hold the port's
    orbax steps, and the best checkpoint decodes 16 trajectories through
    the offline path (K=20 diverse beams). Returns the best checkpoint's
    model."""
    ckpts = {sub: list_steps(os.path.join(run, sub))
             for sub in ("save", "best")}
    print("%s: checkpoints %s, best step %d" % (
        what, {k: [s for s, _ in v] for k, v in ckpts.items()}, best_step))
    if not ckpts["save"] or not ckpts["best"]:
        raise AssertionError("%s: a checkpoint directory is empty" % what)
    if not all(is_orbax_step(p) and written_by_port(p)
               for steps in ckpts.values() for _, p in steps):
        raise AssertionError("%s: a saved step is not an orbax step of the "
                             "port" % what)
    model = params_from_jax(read_checkpoint_tree(ckpts["best"][-1][1]))
    beam_cfg = cfg.replace(use_beam_search=True, beam_size=20,
                           diverse_beam=True, diverse_gamma=0.01,
                           fix_num_timestep=1)
    inputs = inference.synthesize_multifuture_inputs(beam_cfg, 16, seed=1)
    out, prob = inference.run_multifuture_inference(
        model, inputs, beam_cfg, batch_size=16, device=dev)
    check_pickles(out, prob, inputs, beam_cfg)
    print("%s: the best checkpoint decoded 16 trajectories (K=20 beams)"
          % what)
    return model


def step_throughput(what: str, run_step, batch_size: int) -> dict:
    """Buffered steps/s and examples/s of ``run_step`` (3 warm-up steps,
    then 20 with one sync at the end), the device idle share over 5
    steps and the top device operations of one step (torch.profiler).
    Returns the steps/s and the idle share."""
    for _ in range(3):
        run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_steps = 20
    for _ in range(n_steps):
        run_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("%s: %.2f steps/s, %.1f examples/s buffered (%d steps of batch "
          "%d, one sync)" % (what, n_steps / dt, n_steps * batch_size / dt,
                             n_steps, batch_size))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            run_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    print("%s: device idle share over 5 steps %.4f (busy %.2f ms of %.2f "
          "ms)" % (what, 1 - busy / window_ms, busy, window_ms))
    result = {"steps_s": n_steps / dt, "idle": 1 - busy / window_ms}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    total = device_busy_ms(prof)
    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:10]
    print("%s: one step's device time %.3f ms; top operations:"
          % (what, total))
    for e in top:
        print("  %8.3f ms %5.1f%% x%-4d %s" % (
            e.self_device_time_total / 1e3,
            100 * e.self_device_time_total / 1e3 / total, e.count,
            e.key[:100]))
    return result


# ----------------------------------------------------------- JAX checkpoint


def jax_checkpoint_phase(dev, tmp: str, card: str) -> dict:
    """Phase 10: the JAX package's orbax run directory read, served and
    decoded by the port alone (no orbax, tensorstore or zstandard).
    Returns the main-path launches of K1 and K3."""
    t0 = time.perf_counter()
    zstd.load()
    print("jax checkpoint: zstd decoder built and loaded in %.3f s (g++ "
          "-O3 on this host)" % (time.perf_counter() - t0))
    src_save = os.path.join(JAX_FIXTURE, "multiverse", "00", "save")
    step, step_dir = orbax_steps(src_save)[-1]
    disk = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(step_dir) for f in files)
    t0 = time.perf_counter()
    tree = read_checkpoint_tree(src_save)
    read_s = time.perf_counter() - t0
    full = Multiverse.init(MultiverseConfig(
        use_gnn=True, use_scene_enc=True, use_grids=FIXTURE_GRIDS).validate())
    want_tree = fixture_tree(full)
    leaves = _equal_trees("jax checkpoint: the step read against the "
                          "leaves made from the fixture's seed", tree,
                          want_tree)
    f32 = 4 * sum(v.size for v in _flat_leaves(tree))
    print("jax checkpoint: step %d at the published widths (%d leaves, %d "
          "parameters) equal to the leaves made from its seed at tolerance "
          "0; host read %.4f s: %.1f MB/s of files (%d bytes, mostly "
          "codebook frames), %.1f MB/s of f32 (%s)"
          % (step, leaves, f32 // 4, read_s, disk / read_s / 1e6, disk,
             f32 / read_s / 1e6, card))
    # the decoder alone on the frame of a leaf of plain random weights
    # (Huffman-coded literals), as a trained checkpoint's frames are
    db = OcdbtReader(os.path.join(step_dir, "default"))
    key = "params." + FIXTURE_PLAIN_LEAF.replace("/", ".")
    shape = json.loads(db.read(key + "/.zarray"))["shape"]
    chunk = db.read(key + "/" + ".".join("0" * len(shape)))
    out_bytes, reps = 4 * int(np.prod(shape)), 50
    t0 = time.perf_counter()
    for _ in range(reps):
        zstd.decompress(chunk, out_bytes)
    frame_s = (time.perf_counter() - t0) / reps
    rate = out_bytes / frame_s / 1e6
    print("jax checkpoint: the %d-byte frame of %s (plain random f32, %d "
          "bytes out) decoded in %.6f s: %.1f MB/s of f32; %.2f MB of such "
          "frames (a published-width checkpoint of trained or random "
          "weights) at that rate: %.3f s (%s)"
          % (len(chunk), FIXTURE_PLAIN_LEAF, out_bytes, frame_s, rate,
             f32 / 1e6, f32 / 1e6 / rate, card))
    cfg = flagship_config()
    model = load_checkpoint(src_save, Multiverse.init(cfg))
    expected = prune_to_template(want_tree, Multiverse.init(cfg))
    have = dict(model.named_parameters())
    if sorted(have) != sorted(n for n, _ in expected.named_parameters()) \
            or not all(torch.equal(have[n], q)
                       for n, q in expected.named_parameters()):
        raise AssertionError("jax checkpoint: load_checkpoint at use_grids "
                             "1,0 differs from the fixture's leaves pruned")

    outbase = os.path.join(tmp, "jax_out")
    shutil.copytree(os.path.join(JAX_FIXTURE, "multiverse"),
                    os.path.join(outbase, "multiverse"))
    save_dir = os.path.join(outbase, "multiverse", "00", "save")
    expected = expected.to(dev)
    launches = {"K1": 0, "K3": 0}

    def drive(server):
        """In place of the front end's wait: the phase's traffic."""
        engine = server.engine
        scfg = engine.cfg
        if (scfg.compute_dtype, scfg.decode_quant, engine.max_batch,
                scfg.beam_size, scfg.dec_hidden_size) != (
                "bfloat16", "int8a", 8, 20, 256):
            raise AssertionError(
                "jax checkpoint: served %s + %s, max_batch %d, K = %d, "
                "D = %d" % (scfg.compute_dtype, scfg.decode_quant,
                            engine.max_batch, scfg.beam_size,
                            scfg.dec_hidden_size))
        NK = engine.max_batch * scfg.beam_size
        ops, quant, H, W = kernel_operands(engine._params, scfg, dev, NK)
        q8 = {k: v for k, v in ops.items()
              if k not in ("cell_w", "emb_table")}
        check_q8("K3 at the JAX checkpoint's %d rows" % NK, quant, q8, H, W,
                 attn_q8=True)
        rng = np.random.RandomState(6)
        obs = [np.stack([rng.uniform(0, scfg.video_w, scfg.obs_len),
                         rng.uniform(0, scfg.video_h, scfg.obs_len)],
                        axis=1).astype(np.float32) for _ in range(8)]
        pred_lens = rng.randint(1, engine.T_pred + 1, len(obs))
        launches["K3"] += serve_burst(
            engine, scfg, server, "jax checkpoint step %d (asyncio)" % step,
            obs, pred_lens, n_threads=4)
        T = engine.T_pred
        client = PredictionClient(port=server.port, binary=True)
        try:
            answer = client.predict(obs[0], pred_len=T)
        finally:
            client.close()
        trajs, logprobs = direct_forward(engine, scfg, obs[0], T,
                                         params=expected)
        diffs = {"logprobs": float(np.abs(answer["logprobs"]
                                          - logprobs).max()),
                 "trajs": float(np.abs(answer["trajs"] - trajs).max())}
        print("jax checkpoint: a served response vs a direct forward on "
              "the seed's weights: max abs diffs %s" % diffs)
        if not max(diffs.values()) <= 1e-3:
            raise AssertionError("jax checkpoint: the served response does "
                                 "not follow the checkpoint's weights")

    with mock.patch.object(AsyncPredictionServer, "wait", drive):
        serve.main([outbase, "multiverse", "--port", "0", *QUICKSTART_FLAGS])

    # the offline decode, as mvt-torch-multifuture-inference loads its
    # model_path (the save directory), in bf16: K1
    omodel = inference_cli.load_model(save_dir, cfg)
    inputs = inference.synthesize_multifuture_inputs(cfg, 16, seed=5)
    launches["K1"] += offline_run(omodel, cfg, inputs, dev, "none")
    return launches


# ------------------------------------------------------ checkpoint writing

# the committed TF1 bundle (tests/make_tf_fixture.py writes it): the
# reference's names at these widths, use_grids 1,0, scene encoder and
# GNN on, leaves from fixture_leaf; the flags convert it
TF_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "torch_fixtures", "tf_ckpt")
TF_FIXTURE_WIDTHS = {"emb_size": 16, "enc_hidden_size": 32,
                     "dec_hidden_size": 32, "scene_conv_dim": 16}
TF_FIXTURE_FLAGS = ["--emb_size", "16", "--enc_hidden_size", "32",
                    "--dec_hidden_size", "32", "--scene_conv_dim", "16",
                    "--use_grids", "1,0", "--use_scene_enc", "--use_gnn"]


def _equal_trees(what: str, got: dict, want: dict) -> int:
    """Raise unless two nested dicts of arrays hold the same names and
    equal leaves (tolerance 0). Returns the leaf count."""
    got = dict(zip(_flat_names(got), _flat_leaves(got)))
    want = dict(zip(_flat_names(want), _flat_leaves(want)))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: the names differ")
    unequal = [k for k in want if got[k].shape != want[k].shape
               or not np.array_equal(got[k], want[k])]
    if unequal:
        raise AssertionError(f"{what}: {unequal} differ")
    return len(want)


def decode_beams(model, cfg, inputs, dev, tier: str):
    """Beam ids and log-probs of one batch of ``inputs`` through the
    tier's kernel, and its launches."""
    T = int(inputs.pred_lengths.max())
    batch = batch_to_device(inference.make_batch(
        inputs, np.arange(len(inputs.traj_ids)), cfg), dev)
    reset_launches()
    with torch.inference_mode():
        beam, _ = inference.beam_forward(
            model, batch, cfg.replace(decode_quant=tier), T_pred=T)
    torch.cuda.synchronize()
    launches = tier_launches(tier)
    if launches != T:
        raise AssertionError(f"checkpoint writing: the {tier} decode ran "
                             f"{launches} kernel steps, expected {T}")
    return beam.ids.cpu(), beam.logprobs.cpu(), launches


def checkpoint_writing_phase(dev, tmp: str, card: str) -> dict:
    """Phase 13 (see the module docstring). Returns the main-path
    launches of K1 and K3."""
    launches = {"K1": 0, "K3": 0}
    # (a) the published model, both scales, written and read back
    full = Multiverse.init(MultiverseConfig(
        use_gnn=True, use_scene_enc=True, use_grids=FIXTURE_GRIDS).validate(),
        seed=13)
    want = params_to_numpy_tree(full)
    n = sum(v.size for v in _flat_leaves(want))
    run = os.path.join(tmp, "written", "multiverse", "00")
    t0 = time.perf_counter()
    path = CheckpointManager(run).save(13, full)
    write_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
    t0 = time.perf_counter()
    tree = read_checkpoint_tree(os.path.join(run, "save"))
    read_s = time.perf_counter() - t0
    leaves = _equal_trees("checkpoint writing: the step read back", tree,
                          want)
    print("checkpoint writing: %d parameters (%d leaves, published widths, "
          "use_grids 1,1) saved as orbax step %s: %d bytes on disk; host "
          "write %.4f s (%.1f MB/s of f32), read back %.4f s (%.1f MB/s of "
          "f32), equal at tolerance 0 (%s)"
          % (n, leaves, path, disk, write_s, 4 * n / write_s / 1e6, read_s,
             4 * n / read_s / 1e6, card))
    cfg = flagship_config()
    before = prune_to_template(full, Multiverse.init(cfg)).to(dev)
    after = load_checkpoint(path, Multiverse.init(cfg)).to(dev)
    inputs = inference.synthesize_multifuture_inputs(cfg, 16, seed=13)
    for tier, k in (("none", "K1"), ("int8a", "K3")):
        ids_b, lp_b, _ = decode_beams(before, cfg, inputs, dev, tier)
        ids_a, lp_a, ran = decode_beams(after, cfg, inputs, dev, tier)
        launches[k] += ran
        if not (torch.equal(ids_a, ids_b) and torch.equal(lp_a, lp_b)):
            raise AssertionError(
                f"checkpoint writing: the {tier} decode of the weights read "
                "back differs from the decode before the write")
        print("checkpoint writing: %s (%s, %d launches) on the weights "
              "read back: beam ids and log-probs of 16 trajectories equal "
              "to the decode before the write, bit for bit"
              % (k, "bf16" if tier == "none" else tier, ran))

    # (c) the committed TF bundle through mvt-torch-convert-tf
    from multiverse_torch.cli import convert_tf

    outbase = os.path.join(tmp, "tf_out")
    t0 = time.perf_counter()
    convert_tf.main([TF_FIXTURE, outbase, "tfconv", "0", *TF_FIXTURE_FLAGS])
    convert_s = time.perf_counter() - t0
    tf_cfg = flagship_config(**TF_FIXTURE_WIDTHS)
    tf_want = fixture_tree(Multiverse.init(tf_cfg))
    conv_run = os.path.join(outbase, "tfconv", "00")
    for sub in ("save", "best"):
        steps = list_steps(os.path.join(conv_run, sub))
        if [s for s, _ in steps] != [0]:
            raise AssertionError(f"tf conversion: {sub} holds {steps}")
        leaves = _equal_trees(f"tf conversion: {sub} step 0",
                              read_checkpoint_tree(steps[0][1]), tf_want)
    print("tf conversion: %s (%d bytes) converted by mvt-torch-convert-tf in "
          "%.3f s (host); %d leaves of save and best step 0 equal to the "
          "leaves remade from the fixture's seed at tolerance 0"
          % (TF_FIXTURE, sum(os.path.getsize(os.path.join(TF_FIXTURE, f))
                             for f in os.listdir(TF_FIXTURE)),
             convert_s, leaves))
    prepro = synthesize_prepro(os.path.join(tmp, "tf_prepro"), tf_cfg,
                               n_train=16, n_val=32, seed=13)
    shutil.copy(os.path.join(prepro, "data_val.npz"),
                os.path.join(prepro, "data_test.npz"))
    reset_launches()
    perf = test_cli.main([prepro, outbase, "tfconv", "--load_best",
                          "--batch_size", "16", "--compute_dtype",
                          "bfloat16", "--device", "cuda:0",
                          *TF_FIXTURE_FLAGS])
    torch.cuda.synchronize()
    launches["K1"] += decode_step_gathered.launches
    if not decode_step_gathered.launches \
            or not np.isfinite(perf["grid0_traj_ade"]):
        raise AssertionError(f"tf conversion: mvt-torch-test gave {perf}, "
                             f"K1 {decode_step_gathered.launches}")
    print("tf conversion: mvt-torch-test --load_best on the converted run "
          "(bf16, 32 test examples): grid0_traj_ade %.4f, K1 %d"
          % (perf["grid0_traj_ade"], decode_step_gathered.launches))
    model = inference_cli.load_model(os.path.join(conv_run, "best"), tf_cfg)
    launches["K3"] += offline_run(
        model, tf_cfg, inference.synthesize_multifuture_inputs(tf_cfg, 16,
                                                               seed=14),
        dev, "int8a")
    return launches


def _flat_names(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, prefix + k + "/")
        else:
            yield prefix + k


def _flat_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_leaves(v)
        else:
            yield v


def wmma_shares(tree: str) -> None:
    """The K1 shares of the library built from another checkout's
    ``multiverse_torch/csrc`` (its ``_build.py``, loaded as a file: it
    imports nothing of its package), called through that checkout's C
    interface before the wgmma bf16 gate launch (``mv_gnn_attention``,
    and ``mv_gate_lstm`` on the plain cell_w), on this tree's kernel-phase
    operands and plain versions: its attention's bf16 h2 equal to the
    plain h2, and its gate launch's c' on the plain h2 equal to the plain
    gate's. Prints both, for the limits of ``k1_launches``."""
    spec = importlib.util.spec_from_file_location(
        "wmma_build", os.path.join(tree, "multiverse_torch", "ops",
                                   "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.load_library()
    dev = torch.device("cuda")
    cfg = flagship_config()
    model = Multiverse.init(cfg, seed=0, device=dev)
    ops, _, H, W = kernel_operands(model, cfg, dev, NK=16 * cfg.beam_size)
    NK = ops["prev_ids"].shape[0]
    M, D = ops["h"].shape
    C, E = ops["scene"].shape[-1], ops["emb_table"].shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    args = (ops["parent_rows"], ops["h"], ops["scene"], H, W)
    h2 = torch.empty((M, D), dtype=bf, device=dev)
    build.check(lib, lib.mv_gnn_attention(
        ops["parent_rows"].data_ptr(), ops["h"].data_ptr(),
        ops["scene"].data_ptr(), h2.data_ptr(), NK, H, W, D, C, stream),
        "gnn_attention")
    ref_h2 = gate_input_bf16_ref(*args)
    h_out = torch.empty((M, D), dtype=bf, device=dev)
    c_out = torch.empty((M, D), dtype=bf, device=dev)
    build.check(lib, lib.mv_gate_lstm(
        ops["prev_ids"].data_ptr(), ops["parent_rows"].data_ptr(),
        ops["emb_table"].data_ptr(), ref_h2.data_ptr(), ops["c"].data_ptr(),
        ops["cell_w"].data_ptr(), ops["cell_b"].data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), NK, H, W, D, E, 1.0, stream), "gate_lstm")
    torch.cuda.synchronize()
    want = gate_lstm_bf16_ref(ops["cell_w"], ops["cell_b"], ops["prev_ids"],
                              ops["parent_rows"], ops["emb_table"], ref_h2,
                              ops["c"], H, W)[1]
    h2_steps, c_steps = bf16_steps(h2, ref_h2), bf16_steps(c_out, want)
    print("wmma-era K1 launches of %s at %d rows: attention h2 equal to the "
          "plain h2 in %.6f of entries (max %d bf16 steps); gate launch on "
          "the plain h2: c' equal in %.6f of entries (max %d bf16 steps, "
          "max %.3f steps of max(|c'|, %g)); this tree's attention launch's "
          "h2 equal to that one's in %.6f of entries"
          % (tree, NK, float((h2_steps == 0).float().mean()),
             int(h2_steps.max()), float((c_steps == 0).float().mean()),
             int(c_steps.max()), float(steps_above(c_out, want, C_FLOOR)
                                      .max()), C_FLOOR,
             float((gate_input_bf16(*args) == h2).float().mean())))


# ------------------------------------------------------- data preparation

# phase 12 (a): the Forking Paths benchmark at its published widths, VIRAT
# scene 0000 at 30 fps, 1920x1080. A multi-future video holds
# PREP_MF_FRAMES frames, so the drop of 12 from frame 40 samples 20 of
# them: obs 8 + pred 12 (300 frames would give pred 14). PREP_MOMENTS
# moments x PREP_CAMERAS cameras x PREP_FUTURES annotated futures: 40
# videos in 8 obs keys (cam4 is the top-down view the evaluators score
# apart). The x-agent (track PREP_X_AGENT) walks as in every future of its
# obs key until PREP_DIVERGE, then turns its own way in each
PREP_MF_FRAMES, PREP_DIVERGE, PREP_X_AGENT = 280, 124, 3
PREP_MOMENTS, PREP_CAMERAS, PREP_FUTURES = 4, ("cam1", "cam4"), 5
PREP_PERSONS, PREP_VEHICLES = 6, 2
# anchor (single-future) videos of PREP_ANCHOR_PERSONS persons: 600 frames
# sampled every 12th are 50 frames, 31 windows of obs 8 + pred 12 a
# person; each goes to the split of its VIRAT source (split-path
# --is_anchor)
PREP_ANCHORS = {"train": 6, "val": 1, "test": 1}
PREP_ANCHOR_PERSONS, PREP_ANCHOR_FRAMES = 4, 600
PREP_ANCHOR_SCENES = {"train": "0400", "val": "0401", "test": "0000"}
# the published configuration for one epoch, one save and eval at its end
PREP_TRAIN_FLAGS = list(TRAIN_FLAGS)
PREP_TRAIN_FLAGS[PREP_TRAIN_FLAGS.index("--num_epochs") + 1] = "1"
PREP_TRAIN_FLAGS[PREP_TRAIN_FLAGS.index("--save_period") + 1] = "100000"
# mvt-torch-multifuture-inference of that run at the training's
# configuration: K = 20 diverse beams (the README quick start), bf16
PREP_DECODE_FLAGS = ["--num_out", "20", "--diverse_beam", "--diverse_gamma",
                     "0.01", "--fix_num_timestep", "1", "--use_gnn",
                     "--use_scene_enc", "--use_soft_grid_class",
                     "--grid_strides", "2,4", "--use_grids", "1,0",
                     "--compute_dtype", "bfloat16", "--device", "cuda"]
# (b): SDD annotations.txt of PREP_SDD_VIDEOS videos of about
# PREP_SDD_LINES lines (the first portrait, rotated by the change list);
# the SDD's 60 video names split into 5 folds; Argoverse logs of
# PREP_ARGO_SWEEPS label files of PREP_ARGO_LABELS cuboids (10 Hz for 30
# s); PREP_GEN_MOMENTS moments with two annotations each
PREP_SDD_VIDEOS, PREP_SDD_LINES, PREP_SDD_ALL = 4, 10000, 60
PREP_ARGO_LOGS, PREP_ARGO_SWEEPS, PREP_ARGO_LABELS = 2, 300, 40
PREP_GEN_MOMENTS = 32
PREP_ARGO_CAL = {"camera_data_": [{
    "key": "image_raw_ring_front_center", "value": {
        "vehicle_SE3_camera_": {
            "translation": [1.65, 0.01, 1.39],
            "rotation": {"coefficients": [0.5, -0.5, 0.5, -0.5]}},
        "focal_length_x_px_": 1392.1, "skew_": 0.0,
        "focal_center_x_px_": 980.2, "focal_length_y_px_": 1392.1,
        "focal_center_y_px_": 604.4}}]}
# (c): the commands that need an optional package the port imports only
# inside them: (command, main, positional arguments)
PREP_GATED = {
    "cv2": (("mvt-torch-sdd-frames", prepare_cli.sdd_frames_main, 3),
            ("mvt-torch-resize-rotate-sdd",
             prepare_cli.resize_rotate_sdd_main, 3),
            ("mvt-torch-extract-frames-seg",
             vis_annotation_cli.extract_frames_seg_main, 5)),
    "yaml": (("mvt-torch-get-vehicle-traj",
              prepare_cli.get_vehicle_traj_main, 4),)}


def walker_boxes(rng, n_frames: int, persons: int, vehicles: int,
                 x_agent: int = -1, turn: float = 0.0,
                 spread: float = 0.8) -> list:
    """Bbox-JSON records of the Forking Paths recorder (``frame_id``,
    ``track_id``, ``class_name``, ``is_x_agent``, ``bbox`` as x, y, w, h)
    in a 1920x1080 frame: persons (40x100 boxes, feet at the walker) and
    vehicles walking straight at up to ``spread`` px a frame, inside the
    frame; the x-agent turns by ``turn`` px a frame after PREP_DIVERGE."""
    n = persons + vehicles
    start = rng.uniform([350.0, 460.0], [1550.0, 740.0], (n, 2))
    vel = rng.uniform(-spread, spread, (n, 2))
    boxes = []
    for f in range(n_frames):
        for t in range(n):
            x, y = start[t] + vel[t] * f
            if t == x_agent and f > PREP_DIVERGE:
                y += turn * (f - PREP_DIVERGE)
            person = t < persons
            w, h = (40.0, 100.0) if person else (200.0, 120.0)
            boxes.append({"frame_id": f,
                          "track_id": t if person else 100 + t,
                          "class_name": "Person" if person else "Vehicle",
                          "is_x_agent": int(t == x_agent),
                          "bbox": [round(float(x) - w / 2, 3),
                                   round(float(y) - h, 3), w, h]})
    return boxes


def write_forking_paths(root: str, cfg) -> dict:
    """Phase 12 (a)'s inputs: the bbox JSONs of the multi-future and
    anchor videos, the rendered mp4 names split-path globs (empty), the
    original VIRAT split lists, and a scene class map per needed frame.
    No recorder runs here to render seg MP4s, so the maps are written
    as the frames-and-seg step writes them (36x64 uint8 .npy in
    ``<name>/<name>_F_%08d.npy``, classes of phase 6's scene id json);
    (c) drives that step on rendered palette videos where cv2 imports."""
    rng = np.random.RandomState(12)
    paths = {k: os.path.join(root, k) for k in (
        "ds", "videos_mf", "videos_anchor", "ori", "scene_anchor",
        "scene_mf")}
    for p in paths.values():
        os.makedirs(p)
    os.makedirs(os.path.join(paths["ds"], "bbox"))

    def write(name: str, boxes: list, videos: str) -> None:
        with open(os.path.join(paths["ds"], "bbox", name + ".json"),
                  "w") as f:
            json.dump(boxes, f)
        open(os.path.join(paths[videos], name + ".mp4"), "w").close()

    def scene_maps(where: str, name: str, frames) -> None:
        os.makedirs(os.path.join(where, name))
        for fr in frames:
            np.save(os.path.join(where, name, "%s_F_%08d.npy" % (name, fr)),
                    rng.randint(0, cfg.scene_class, (cfg.scene_h, cfg.scene_w))
                    .astype(np.uint8))

    obs_keys = []
    for m in range(PREP_MOMENTS):
        for cam in PREP_CAMERAS:
            seed = rng.randint(1 << 30)
            for d in range(PREP_FUTURES):
                write("0000_%d_%d_%d_a%d_%s" % (m, PREP_X_AGENT, d, d, cam),
                      walker_boxes(np.random.RandomState(seed),
                                   PREP_MF_FRAMES, PREP_PERSONS,
                                   PREP_VEHICLES, x_agent=PREP_X_AGENT,
                                   turn=0.25 * (d - PREP_FUTURES // 2)),
                      "videos_mf")
            key = "0000_%d_%d_%s" % (m, PREP_X_AGENT, cam)
            obs_keys.append(key)
            scene_maps(paths["scene_mf"], key, range(0, 8 * 12, 12))
    anchors = {}
    for split, n in PREP_ANCHORS.items():
        for v in range(n):
            source = "VIRAT_S_%s%02d_00" % (PREP_ANCHOR_SCENES[split], v)
            name = "%s_F_%d_1" % (source, v)
            anchors.setdefault(split, []).append(name)
            write(name, walker_boxes(rng, PREP_ANCHOR_FRAMES,
                                     PREP_ANCHOR_PERSONS, PREP_VEHICLES,
                                     spread=0.5), "videos_anchor")
            scene_maps(paths["scene_anchor"], name,
                       range(0, PREP_ANCHOR_FRAMES, 12))
        with open(os.path.join(paths["ori"], split + ".lst"), "w") as f:
            f.write("".join("videos/%s.mp4\n" % a.split("_F_")[0]
                            for a in anchors[split]))
    paths.update(obs_keys=obs_keys, anchors=anchors)
    return paths


def timed_main(what: str, card: str, main, argv: list, rows: int,
               unit: str):
    """Run a command's ``main`` once; prints its host seconds and
    ``rows`` ``unit`` a second beside the card's name and power limit
    (host numpy: the card is idle). Returns (seconds, what it returned)."""
    t0 = time.perf_counter()
    out = main(argv)
    dt = time.perf_counter() - t0
    print("data-prep phase (%s): %s %.4f s, %d %s, %.1f %s/s (host)"
          % (card, what, dt, rows, unit, rows / dt, unit))
    return dt, out


def need_files(what: str, paths) -> None:
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise AssertionError("%s: missing %s" % (what, missing[:5]))


def scores(main, argv: list) -> list:
    """The numbers an evaluator prints on its last line (it prints them
    here too)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    print(text, end="")
    return [float(x) for x in text.strip().splitlines()[-1].split()]


def prep_chain(dev, tmp: str, card: str) -> dict:
    """Phase 12 (a): bbox JSONs -> split-path -> prepare-multifuture and
    prepare-anchor -> preprocess -> one epoch of training -> the bf16 and
    int8a multi-future decodes -> both evaluators. Returns the launches of
    K1, K3, K4 and K5."""
    cfg = train_config()
    root = os.path.join(tmp, "prep")
    inp = write_forking_paths(root, cfg)
    id2name = os.path.join(tmp, "scene36_64_id2name_top10.json")
    out = {k: os.path.join(root, k) for k in (
        "split_mf", "split_anchor", "obs", "mf", "anchor", "prepro", "out")}
    n_mf = PREP_MOMENTS * len(PREP_CAMERAS) * PREP_FUTURES
    n_anchor = sum(PREP_ANCHORS.values())

    timed_main("mvt-torch-split-path (multi-future)", card,
               prepare_cli.split_path_main,
               [inp["videos_mf"], out["split_mf"]], n_mf, "videos")
    timed_main("mvt-torch-split-path --is_anchor", card,
               prepare_cli.split_path_main,
               [inp["videos_anchor"], out["split_anchor"], "--is_anchor",
                "--ori_split_path", inp["ori"]], n_anchor, "videos")
    with open(os.path.join(out["split_mf"], "test.lst")) as f:
        if len(f.read().split()) != n_mf:
            raise AssertionError("split-path: not every video in test.lst")
    stats = []
    real = prepared_data.prepare_multifuture_split

    def recorded(*args, **kw):
        stats.append(real(*args, **kw))
        return stats[-1]
    boxes = n_mf * PREP_MF_FRAMES * (PREP_PERSONS + PREP_VEHICLES)
    with mock.patch.object(prepared_data, "prepare_multifuture_split",
                           recorded):
        timed_main("mvt-torch-prepare-multifuture", card,
                   prepare_cli.prepare_multifuture_main,
                   [inp["ds"], out["split_mf"], out["obs"], out["mf"]],
                   boxes, "boxes")
    if len(stats) != 1 or stats[0]["skipped"] != 0 \
            or stats[0]["num_obs"] != len(inp["obs_keys"]):
        raise AssertionError(f"prepare-multifuture: {stats}")
    need_files("prepare-multifuture", [
        os.path.join(out[d], sub, "test", key + ext)
        for key in inp["obs_keys"] for d, sub, ext in (
            ("obs", "traj_2.5fps", ".txt"), ("obs", "anno_person_box", ".p"),
            ("obs", "anno_other_box", ".p"), ("mf", "", ".p"))])
    for key in inp["obs_keys"]:
        with open(os.path.join(out["mf"], "test", key + ".p"), "rb") as f:
            gt = pickle.load(f)
        lengths = [len(g["x_agent_traj"]) for g in gt.values()]
        if lengths != [12] * PREP_FUTURES:
            raise AssertionError(f"{key}: GT futures of {lengths} steps")
    timed_main("mvt-torch-prepare-anchor", card,
               prepare_cli.prepare_anchor_main,
               [inp["ds"], out["split_anchor"], out["anchor"]],
               n_anchor * PREP_ANCHOR_FRAMES
               * (PREP_ANCHOR_PERSONS + PREP_VEHICLES), "boxes")
    need_files("prepare-anchor", [
        os.path.join(out["anchor"], sub, split, name + ext)
        for split, names in inp["anchors"].items() for name in names
        for sub, ext in (("traj_2.5fps", ".txt"), ("anno_person_box", ".p"),
                         ("anno_other_box", ".p"))])
    windows = (PREP_ANCHOR_FRAMES // 12 - cfg.seq_len + 1) \
        * PREP_ANCHOR_PERSONS
    timed_main("mvt-torch-preprocess (anchor TSVs)", card,
               preprocess_cli.main,
               [os.path.join(out["anchor"], "traj_2.5fps"), out["prepro"],
                "--scene_feat_path", inp["scene_anchor"],
                "--scene_id2name", id2name, *PREPRO_FLAGS],
               n_anchor * windows, "examples")
    for split, n in PREP_ANCHORS.items():
        with np.load(os.path.join(out["prepro"], "data_%s.npz" % split),
                     allow_pickle=True) as d:
            if len(d["obs_traj"]) != n * windows:
                raise AssertionError(f"preprocess: {split} has "
                                     f"{len(d['obs_traj'])} examples")

    reset_launches()
    t0 = time.perf_counter()
    result = train_cli.main([out["prepro"], out["out"], "prepared",
                             *PREP_TRAIN_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K4": gnn_dense_fwd.launches, "K5": gnn_dense_bwd.launches,
                "K1": decode_step_gathered.launches}
    steps = result["steps"]
    eval_batches = -(-PREP_ANCHORS["val"] * windows // cfg.batch_size)
    print("data-prep phase: mvt-torch-train one epoch on the prepared data, "
          "%d steps in %.3f s; launches K4 %d, K5 %d, eval K1 %d"
          % (steps, wall, launches["K4"], launches["K5"], launches["K1"]))
    if steps != -(-PREP_ANCHORS["train"] * windows // cfg.batch_size) \
            or launches["K4"] != steps * cfg.pred_len \
            or launches["K5"] != steps * cfg.pred_len \
            or launches["K1"] != eval_batches * cfg.pred_len:
        raise AssertionError(f"data-prep phase: {steps} steps, launches "
                             f"{launches}")
    run = os.path.join(out["out"], "prepared", "00")
    need_files("mvt-torch-train", [os.path.join(run, f) for f in (
        "config.json", "val_perf.json", "save", "best")])

    launches["K3"] = 0
    for tier, kernel in (("none", "K1"), ("int8a", "K3")):
        traj_p = os.path.join(root, "%s.traj.p" % tier)
        prob_p = os.path.join(root, "%s.prob.p" % tier)
        reset_launches()
        t0 = time.perf_counter()
        inference_cli.main([os.path.join(run, "save"),
                            os.path.join(out["obs"], "traj_2.5fps", "test"),
                            os.path.join(out["mf"], "test"), traj_p,
                            "--save_prob_file", prob_p, "--decode_quant",
                            tier, "--scene_feat_path", inp["scene_mf"],
                            "--scene_id2name", id2name, *PREP_DECODE_FLAGS])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran = tier_launches(tier)
        batches = -(-len(inp["obs_keys"]) // 16)
        print("data-prep phase: mvt-torch-multifuture-inference %s on the "
              "%d prepared obs in %.3f s (load included); %s ran %d times "
              "(%d batches x T 12)" % (tier, len(inp["obs_keys"]), dt,
                                       kernel, ran, batches))
        if ran != batches * 12:
            raise AssertionError(f"the {tier} decode ran {ran} steps")
        launches[kernel] += ran
        with open(traj_p, "rb") as f:
            trajs = pickle.load(f)
        with open(prob_p, "rb") as f:
            probs = pickle.load(f)
        if sorted(trajs) != sorted(inp["obs_keys"]) \
                or sorted(probs) != sorted(trajs) \
                or any(np.asarray(t).shape != (20, 12, 2)
                       or not np.isfinite(np.asarray(t)).all()
                       for t in trajs.values()):
            raise AssertionError(f"the {tier} pickles")
        ade_fde = scores(eval_trajs_cli.main,
                         [os.path.join(out["mf"], "test"), traj_p])
        nll = scores(eval_prob_cli.main,
                     [os.path.join(out["mf"], "test"), prob_p])
        print("data-prep phase: %s minADE/minFDE (45-degree, top-down, "
              "all) %s; NLL T=1..5 %s (one epoch of training: "
              "information, not a gate)" % (tier, ade_fde, nll))
        if len(ade_fde) != 6 or len(nll) != 5 \
                or not np.isfinite(ade_fde + nll).all():
            raise AssertionError(f"the {tier} scores are not finite")
    return launches


def write_sdd(root: str) -> dict:
    """SDD's ``annotations.txt`` layout (track x1 y1 x2 y2 frame lost
    occluded generated "label") for PREP_SDD_VIDEOS videos of about
    PREP_SDD_LINES lines at 30 fps, the first portrait (rotated by the
    change list), with the change list and split lists."""
    rng = np.random.RandomState(13)
    labels = ["Pedestrian", "Pedestrian", "Biker", "Car", "Skater", "Cart",
              "Bus", "Pedestrian"]
    ids, lines_total = [], 0
    changes = []
    for v in range(PREP_SDD_VIDEOS):
        scene, video = ("bookstore", "deathCircle", "gates", "hyang")[v % 4], \
            "video%d" % v
        w, h = (1088, 1424) if v == 0 else (1424, 1088)
        d = os.path.join(root, "annotations", scene, video)
        os.makedirs(d)
        tracks, frames = 10, PREP_SDD_LINES // 10
        lines = []
        for t in range(tracks):
            x, y = rng.uniform(0, 0.85 * w), rng.uniform(0, 0.85 * h)
            vx, vy = rng.uniform(-0.1, 0.1, 2)
            for f in range(frames):
                x1, y1 = int(x + vx * f), int(y + vy * f)
                lines.append('%d %d %d %d %d %d %d %d 0 "%s"' % (
                    t, x1, y1, x1 + 30, y1 + 60, f, int(rng.rand() < 0.02),
                    int(rng.rand() < 0.1), labels[t % len(labels)]))
        with open(os.path.join(d, "annotations.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        lines_total += len(lines)
        ids.append("%s_%s" % (scene, video))
        changes.append("%s_%s,%dx%d,%s" % (scene, video, w, h, h > w))
    with open(os.path.join(root, "changes.lst"), "w") as f:
        f.write("\n".join(changes) + "\n")
    split = os.path.join(root, "sdd_split")
    os.makedirs(split)
    for name, part in (("train", ids[:-1]), ("test", ids[-1:])):
        with open(os.path.join(split, name + ".lst"), "w") as f:
            f.write("".join("%s.mp4\n" % i for i in part))
    return {"anno": os.path.join(root, "annotations"), "split": split,
            "changes": os.path.join(root, "changes.lst"), "ids": ids,
            "lines": lines_total}


def argo_cuboid(rng, cls: str, uuid: str, x: float, y: float) -> dict:
    yaw = rng.uniform(-np.pi, np.pi)
    return {"label_class": cls, "track_label_uuid": uuid,
            "occlusion": int(rng.choice([0, 0, 0, 25, 100])),
            "center": {"x": x, "y": y, "z": rng.uniform(-0.2, 0.5)},
            "rotation": {"w": float(np.cos(yaw / 2)), "x": 0.0, "y": 0.0,
                         "z": float(np.sin(yaw / 2))},
            "length": rng.uniform(0.5, 5.0), "width": rng.uniform(0.5, 2.2),
            "height": rng.uniform(1.2, 2.0)}


def write_argoverse(root: str) -> int:
    """PREP_ARGO_LOGS Argoverse tracking logs: per-sweep cuboid label
    JSONs (pedestrians, vehicles, bicycles; some occluded or behind the
    camera) and each log's ``vehicle_calibration_info.json``. Returns the
    number of labels."""
    rng = np.random.RandomState(14)
    classes = ["PEDESTRIAN"] * 4 + ["VEHICLE", "BICYCLE", "LARGE_VEHICLE",
                                    "ON_ROAD_OBSTACLE"]
    n = 0
    for log in range(PREP_ARGO_LOGS):
        d = os.path.join(root, "argoverse", "log%d" % log)
        os.makedirs(os.path.join(d, "per_sweep_annotations_amodal"))
        with open(os.path.join(d, "vehicle_calibration_info.json"),
                  "w") as f:
            json.dump(PREP_ARGO_CAL, f)
        start = rng.uniform([-20.0, -15.0], [60.0, 15.0],
                            (PREP_ARGO_LABELS, 2))
        vel = rng.uniform(-0.1, 0.1, (PREP_ARGO_LABELS, 2))
        for s in range(PREP_ARGO_SWEEPS):
            labels = [argo_cuboid(rng, classes[k % len(classes)],
                                  "log%d-track%d" % (log, k),
                                  *(start[k] + vel[k] * s))
                      for k in range(PREP_ARGO_LABELS)]
            n += len(labels)
            with open(os.path.join(d, "per_sweep_annotations_amodal",
                                   "tracked_object_labels_%d.json"
                                   % (315969629019741000 + s * 100000000)),
                      "w") as f:
                json.dump(labels, f)
    return n


def write_moments(root: str) -> dict:
    """PREP_GEN_MOMENTS moments (controls by ``traj_to_controls`` of 10
    persons and 3 vehicles over 20 s at 2.5 fps, as `mvt-build-moment`
    writes them) and two annotators' annotations of each."""
    rng = np.random.RandomState(15)
    moments_data = []
    for m in range(PREP_GEN_MOMENTS):
        rows = [(f, float(p), x + 0.02 * f * vx, y + 0.02 * f * vy, 0.5)
                for p, (x, y, vx, vy) in enumerate(
                    rng.uniform(-10, 10, (10, 4)))
                for f in range(0, 600, 12)]
        ped, _ = fp_controls.traj_to_controls(np.asarray(rows), -1, -1, 30.0)
        veh_rows = [(f, 100.0 + p, x + 0.1 * f, y, 0.0)
                    for p, (x, y) in enumerate(rng.uniform(-20, 20, (3, 2)))
                    for f in range(0, 600, 30)]
        veh, _ = fp_controls.traj_to_controls(np.asarray(veh_rows), -1, -1,
                                              30.0, z_to=0.0)
        moments_data.append({"scenename": "0400", "ped_controls": ped,
                             "vehicle_controls": veh, "x_agents": [1]})
    moment_file = os.path.join(root, "moments.json")
    with open(moment_file, "w") as f:
        json.dump(moments_data, f)
    with open(os.path.join(root, "moments.lst"), "w") as f:
        f.write(moment_file + "\n")
    lines = []
    for a, annotator in enumerate(("annotator0", "annotator1")):
        annos = {"0400_%d_1_%d" % (m, a): [
            [f, [0.0, 1.0, 0.0], 1.4, [0.01 * f, 0.02 * f, 0.5]]
            for f in range(120, 480, 3)] for m in range(PREP_GEN_MOMENTS)}
        path = os.path.join(root, "%s.json" % annotator)
        with open(path, "w") as f:
            json.dump(annos, f)
        lines.append("%s %s" % (path, annotator))
    with open(os.path.join(root, "annotations.lst"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"moments": os.path.join(root, "moments.lst"),
            "annotations": os.path.join(root, "annotations.lst")}


def prep_host_commands(tmp: str, card: str, anchor_traj: str) -> None:
    """Phase 12 (b): the other host commands on generated inputs at the
    sizes of their datasets, each timed and checked for its outputs.
    ``anchor_traj``: (a)'s anchor TSVs, whose VIRAT videos
    mvt-torch-combine-traj merges back per video."""
    root = os.path.join(tmp, "prep_host")
    os.makedirs(root)
    sdd_in = write_sdd(root)
    sdd_out = os.path.join(root, "sdd_prepared")
    timed_main("mvt-torch-prepare-sdd (%d videos)" % PREP_SDD_VIDEOS, card,
               prepare_cli.prepare_sdd_main,
               [sdd_in["anno"], sdd_in["split"], sdd_in["changes"], sdd_out],
               sdd_in["lines"], "annotation lines")
    need_files("prepare-sdd", [
        os.path.join(sdd_out, sub, split, vid + ext)
        for split, vids in (("train", sdd_in["ids"][:-1]),
                            ("test", sdd_in["ids"][-1:])) for vid in vids
        for sub, ext in (("traj_2.5fps", ".txt"), ("anno_person_box", ".p"),
                         ("anno_other_box", ".p"))])

    videolst = os.path.join(root, "sdd_videos.lst")
    with open(videolst, "w") as f:
        f.write("".join("sdd/videos/%d/video.mov\n" % i
                        for i in range(PREP_SDD_ALL)))
    folds = os.path.join(root, "sdd_folds")
    timed_main("mvt-torch-sdd-splits (5 folds)", card,
               prepare_cli.sdd_splits_main, [videolst, folds], PREP_SDD_ALL,
               "videos")
    for i in range(1, 6):
        names = []
        for part in ("test", "val", "train"):
            with open(os.path.join(folds, "fold_%d" % i,
                                   part + ".lst")) as f:
                names += f.read().split()
        if sorted(names) != ["video.mov"] * PREP_SDD_ALL:
            raise AssertionError(f"sdd-splits: fold {i} has {len(names)}")

    n_labels = write_argoverse(root)
    argo_out = os.path.join(root, "argoverse_prepared")
    timed_main("mvt-torch-prepare-argoverse (%d logs)" % PREP_ARGO_LOGS,
               card, prepare_cli.prepare_argoverse_main,
               [os.path.join(root, "argoverse"), argo_out], n_labels,
               "cuboid labels")
    need_files("prepare-argoverse", [
        os.path.join(argo_out, sub, "test", "log%d%s" % (log, ext))
        for log in range(PREP_ARGO_LOGS)
        for sub, ext in (("traj_2.5fps", ".txt"), ("anno_person_box", ".p"),
                         ("anno_other_box", ".p"))])

    h_path = os.path.join(root, "homography")
    os.makedirs(h_path)
    rng = np.random.RandomState(16)
    for scene in PREP_ANCHOR_SCENES.values():
        hm = np.eye(3) * 0.05 + rng.uniform(-1e-3, 1e-3, (3, 3))
        hm[2, 2] = 1.0
        with open(os.path.join(h_path, scene + ".txt"), "w") as f:
            f.write("\n".join(",".join("%.9f" % v for v in row)
                              for row in hm) + "\n")
    videos = sorted(os.path.splitext(n)[0] for s in PREP_ANCHORS
                    for n in os.listdir(os.path.join(anchor_traj, s)))
    rows = sum(1 for s in PREP_ANCHORS
               for n in os.listdir(os.path.join(anchor_traj, s))
               for _ in open(os.path.join(anchor_traj, s, n)))
    for flags in ([], ["--is_actev", "--h_path", h_path, "--target_w_path",
                       os.path.join(root, "combined_world")]):
        target = os.path.join(root, "combined_%d" % len(flags))
        frames = target + "_frames.json"
        timed_main("mvt-torch-combine-traj %s" % (
            " ".join(flags[:1]) or "(pixel only)"), card,
                   prepare_cli.combine_traj_main,
                   [anchor_traj, target, frames, *flags], rows, "rows")
        with open(frames) as f:
            if sorted(json.load(f)) != videos:
                raise AssertionError("combine-traj: frame file")
        need_files("combine-traj", [
            os.path.join(d, v + ".txt") for v in videos
            for d in [target] + flags[-1:]])

    moments_in = write_moments(root)
    final = os.path.join(root, "final_moments.json")
    timed_main("mvt-torch-gen-moments", card, prepare_cli.gen_moments_main,
               [moments_in["moments"], moments_in["annotations"], final],
               2 * PREP_GEN_MOMENTS, "annotations")
    with open(final) as f:
        if len(json.load(f)) != 2 * PREP_GEN_MOMENTS:
            raise AssertionError("gen-moments: moments")


def importable(package: str) -> bool:
    try:
        importlib.import_module(package)
    except ImportError:
        return False
    return True


def prep_gated_commands(tmp: str, card: str, obs_traj: str) -> dict:
    """Phase 12 (c): where cv2 or yaml cannot be imported, the commands
    that need it must stop with an ImportError naming it and the command,
    having written nothing; where it can, they run on small generated
    videos and YAMLs (``obs_traj``: (a)'s multi-future obs TSVs, whose
    rendered videos are written) and their outputs are checked. Returns
    {package: "missing" or "ran"}."""
    root = os.path.join(tmp, "prep_gated")
    os.makedirs(root)
    seen = {}
    for package, commands in PREP_GATED.items():
        if importable(package):
            seen[package] = "ran"
            print("data-prep phase: %s %s imports here; its commands run"
                  % (package, sys.modules[package].__version__))
            {"cv2": gated_cv2, "yaml": gated_yaml}[package](root, card,
                                                            obs_traj)
            continue
        seen[package] = "missing"
        for command, main, nargs in commands:
            where = os.path.join(root, command)
            os.makedirs(where)
            try:
                main([os.path.join(where, "arg%d" % i)
                      for i in range(nargs)])
            except ImportError as e:
                if e.name != package or command not in str(e) \
                        or os.listdir(where):
                    raise AssertionError(f"{command}: {e!r}") from e
                print("data-prep phase: %s cannot be imported here; %s "
                      "stopped with ImportError: %s" % (package, command, e))
            else:
                raise AssertionError(f"{command} ran without {package}")
    print("data-prep phase: the gated commands %s (cv2: %s, yaml: %s)"
          % ("ran" if set(seen.values()) == {"ran"} else
             "stopped with their ImportErrors where their package is "
             "missing", seen["cv2"], seen["yaml"]))
    return seen


def gated_cv2(root: str, card: str, obs_traj: str) -> None:
    """The cv2 commands on small generated videos: frames of an SDD
    video, a portrait video resized and rotated, the rendered videos of
    (a)'s obs (rgb, and palette seg mp4s beside them) to frames and
    scene class maps."""
    import cv2

    def video(path, n, w, h, frame):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
        for i in range(n):
            vw.write(frame(i))
        vw.release()
    sdd = os.path.join(root, "sdd", "bookstore", "video0.mp4")
    video(sdd, 30, 64, 48, lambda i: np.full((48, 64, 3), i * 8, np.uint8))
    os.makedirs(os.path.join(root, "sdd_traj", "train"))
    with open(os.path.join(root, "sdd_traj", "train", "video0.txt"),
              "w") as f:
        f.write("".join("%d\t1\t5.0\t5.0\n" % fr for fr in range(0, 30, 12)))
    with open(os.path.join(root, "sdd_videos.lst"), "w") as f:
        f.write(sdd + "\n")
    timed_main("mvt-torch-sdd-frames", card, prepare_cli.sdd_frames_main,
               [os.path.join(root, "sdd_videos.lst"),
                os.path.join(root, "sdd_traj"),
                os.path.join(root, "sdd_frames")], 3, "frames")
    need_files("sdd-frames", [os.path.join(
        root, "sdd_frames", "video0_F_%08d.jpg" % fr) for fr in (0, 12, 24)])
    raw = os.path.join(root, "raw", "bookstore", "video0", "video.mov")
    video(raw, 3, 48, 64, lambda i: np.full((64, 48, 3), i * 40, np.uint8))
    with open(os.path.join(root, "raw.lst"), "w") as f:
        f.write(raw + "\n")
    timed_main("mvt-torch-resize-rotate-sdd", card,
               prepare_cli.resize_rotate_sdd_main,
               [os.path.join(root, "raw.lst"), os.path.join(root, "sdd_1080"),
                os.path.join(root, "changes.lst")], 3, "frames")
    with open(os.path.join(root, "changes.lst")) as f:
        if f.read().strip() != "bookstore_video0,48x64,True":
            raise AssertionError("resize-rotate-sdd: the change list")
    videos = os.path.join(root, "render", "videos")
    for name in os.listdir(os.path.join(obs_traj, "test")):
        s, m, pid, cam = os.path.splitext(name)[0].split("_")
        rendered = "%s_%s_%s_0_a0_%s" % (s, m, pid, cam)
        video(os.path.join(videos, rendered + ".mp4"), PREP_MF_FRAMES, 128,
              72, lambda i: np.full((72, 128, 3), i % 200, np.uint8))
        video(os.path.join(videos, rendered + "_seg.mp4"), PREP_MF_FRAMES,
              128, 72, lambda i: np.full((72, 128, 3), (60, 20, 220),
                                         np.uint8))
    bad = os.path.join(root, "bad_video.lst")
    timed_main("mvt-torch-extract-frames-seg", card,
               vis_annotation_cli.extract_frames_seg_main,
               [obs_traj, videos, os.path.join(root, "frames"),
                os.path.join(root, "seg"), bad, "--is_multifuture"],
               8 * len(os.listdir(os.path.join(obs_traj, "test"))), "frames")
    with open(bad) as f:
        if f.read().strip():
            raise AssertionError("extract-frames-seg: bad videos")
    for name in os.listdir(os.path.join(obs_traj, "test")):
        key = os.path.splitext(name)[0]
        seg = np.load(os.path.join(root, "seg", key, key + "_F_00000000.npy"))
        # the CARLA person color (BGR 60, 20, 220) -> ADE20k person, 13
        if seg.shape != (36, 64) or not (seg == 13).all():
            raise AssertionError(f"extract-frames-seg: {key} seg map")


def gated_yaml(root: str, card: str, obs_traj: str) -> None:
    """mvt-torch-get-vehicle-traj on VIRAT YAMLs of two videos
    (``obs_traj`` is not read: the pedestrian TSVs are written here)."""
    traj, anno, h_path = (os.path.join(root, d) for d in (
        "ped_traj", "yaml", "h"))
    for d in (traj, anno, h_path):
        os.makedirs(d)
    rng = np.random.RandomState(17)
    names = ["VIRAT_S_040000_00_000000_000100",
             "VIRAT_S_000201_00_000018_000380"]
    for name in names:
        with open(os.path.join(traj, name + ".txt"), "w") as f:
            f.write("".join("%d\t1\t5.0\t5.0\n" % fr
                            for fr in range(0, 600, 12)))
        geom = ["- {meta: x}"]
        for tid in (3, 8):
            for fr in range(0, 600, 6):
                x1, y1 = rng.uniform(0, 1000, 2)
                geom.append("- {geom: {id1: %d, ts0: %d, g0: %.1f %.1f %.1f "
                            "%.1f, src: truth}}" % (tid, fr, x1, y1 / 2,
                                                    x1 + 80, y1 / 2 + 50))
        with open(os.path.join(anno, name + ".geom.yml"), "w") as f:
            f.write("\n".join(geom) + "\n")
        with open(os.path.join(anno, name + ".types.yml"), "w") as f:
            f.write("- {meta: x}\n- {types: {id1: 3, cset3: {Vehicle: 1.0}}}"
                    "\n- {types: {id1: 8, cset3: {Person: 1.0}}}\n")
    for scene in ("0400", "0002"):
        with open(os.path.join(h_path, scene + ".txt"), "w") as f:
            f.write("0.05,0,0\n0,0.05,0\n0,0,1\n")
    out = os.path.join(root, "vehicle_traj")
    timed_main("mvt-torch-get-vehicle-traj", card,
               prepare_cli.get_vehicle_traj_main, [traj, anno, h_path, out],
               2 * 2 * 100, "boxes")
    for sub in ("pixel", "world"):
        for name in names:
            with open(os.path.join(out, sub, name + ".txt")) as f:
                if len(f.read().splitlines()) != 50:
                    raise AssertionError(f"get-vehicle-traj: {sub}/{name}")


def data_prep_phase(dev, tmp: str, card: str) -> dict:
    """Phase 12 (see the module docstring), in phase 6's temporary
    directory (its scene id json). Returns the launches of K1, K3, K4 and
    K5."""
    launches = prep_chain(dev, tmp, card)
    prep_host_commands(tmp, card, os.path.join(tmp, "prep", "anchor",
                                               "traj_2.5fps"))
    prep_gated_commands(tmp, card, os.path.join(tmp, "prep", "obs",
                                                "traj_2.5fps"))
    return launches


# ------------------------------------------------------------- plotting

# phase 14: the plotting commands on phase 12's files at the published
# frame size. Each obs key gets a PLOT_FRAMES-frame video;
# mvt-torch-vis-multifuture --use_heatmap (one full-frame blur a frame)
# draws every PLOT_HEATMAP_JOB-th key (--job/--curJob 1), the plain run
# every key. mvt-torch-test's pickles are drawn on the first
# PLOT_GRID_FRAMES frames of the test video; mvt-torch-vis-output draws
# PLOT_OUTPUT_NUM images, PLOT_OUTPUT_HEAT of them with --use_heatmap
PLOT_H, PLOT_W = 1080, 1920
PLOT_FRAMES, PLOT_HEATMAP_JOB = 8, 4
PLOT_GRID_FRAMES, PLOT_OUTPUT_NUM, PLOT_OUTPUT_HEAT = 3, 12, 4
# mvt-torch-test's beam decode: the README quick start's K = 20 beams
PLOT_BEAMS = 20
PLOT_BEAM_FLAGS = ["--use_beam_search", "--beam_size", str(PLOT_BEAMS),
                   "--diverse_beam", "--diverse_gamma", "0.01"]


def plot_image(seed: int) -> np.ndarray:
    """A smooth 1920x1080 BGR frame that changes with ``seed``."""
    y = np.arange(PLOT_H, dtype=np.int32)[:, None]
    x = np.arange(PLOT_W, dtype=np.int32)[None, :]
    img = np.empty((PLOT_H, PLOT_W, 3), np.uint8)
    img[..., 0] = (x // 8 + seed * 17) % 256
    img[..., 1] = (y // 5 + seed * 5) % 256
    img[..., 2] = ((x + y) // 12 + seed * 40) % 256
    return img


def plot_main(what: str, card: str, main, argv: list, n: int,
              unit: str = "frames") -> str:
    """Run a command's ``main`` once with its stdout captured (and
    printed); prints its host seconds and ``n`` ``unit`` a second (images
    at 1920x1080) beside the card's name and power limit. Returns what it
    printed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    dt = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    print("plotting phase (%s): %s %.4f s, %d %s, %.2f %s/s%s (host "
          "figures of the card's machine)"
          % (card, what, dt, n, unit, n / dt, unit,
             "" if unit == "rows" else " at %dx%d" % (PLOT_W, PLOT_H)))
    return buf.getvalue()


def drawn_on(what: str, written: list, plain: list) -> None:
    """Each written jpg differs from the jpg of the frame it was drawn
    on, encoded as the commands encode: a frame nothing was drawn on
    would give the same bytes."""
    import cv2

    if len(written) != len(plain) or not written:
        raise AssertionError(f"{what}: {len(written)} files for "
                             f"{len(plain)} frames")
    for path, frame in zip(written, plain):
        with open(path, "rb") as f:
            if f.read() == cv2.imencode(".jpg", frame)[1].tobytes():
                raise AssertionError(f"{what}: nothing drawn on {path}")


def video_frames(path: str) -> list:
    import cv2

    vcap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = vcap.read()
        if not ok:
            break
        frames.append(frame)
    vcap.release()
    return frames


def plot_multifuture(root: str, card: str, prep: str) -> None:
    """(a): a PLOT_FRAMES-frame mp4 of each obs key, then
    mvt-torch-vis-multifuture on phase 12's bf16 (K1) and int8a (K3)
    ``.traj.p``, with and without --use_heatmap, and
    mvt-torch-vis-dataset on the same videos."""
    import cv2

    gt_path = os.path.join(prep, "mf", "test")
    keys = sorted(os.path.splitext(n)[0] for n in os.listdir(gt_path))
    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    t0 = time.perf_counter()
    for k, key in enumerate(keys):
        vw = cv2.VideoWriter(os.path.join(videos, key + ".mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (PLOT_W, PLOT_H))
        for i in range(PLOT_FRAMES):
            vw.write(plot_image(PLOT_FRAMES * k + i))
        vw.release()
    print("plotting phase: %d mp4v videos of %d frames at %dx%d written in "
          "%.3f s" % (len(keys), PLOT_FRAMES, PLOT_W, PLOT_H,
                      time.perf_counter() - t0))
    plain = {key: video_frames(os.path.join(videos, key + ".mp4"))
             for key in keys}
    for tier in ("none", "int8a"):
        traj_p = os.path.join(prep, "%s.traj.p" % tier)
        with open(traj_p, "rb") as f:
            order = list(pickle.load(f))
        if sorted(order) != keys:
            raise AssertionError(f"{traj_p}: keys {order}")
        for heat in (False, True):
            out = os.path.join(root, "mf_%s_%d" % (tier, heat))
            flags = ["--use_heatmap", "--job", str(PLOT_HEATMAP_JOB),
                     "--curJob", "1"] if heat else []
            drawn = [key for c, key in enumerate(order, 1)
                     if not heat or c % PLOT_HEATMAP_JOB == 0]
            plot_main("mvt-torch-vis-multifuture %s%s" % (
                tier, " " + " ".join(flags) if heat else ""), card,
                vis_mf_cli.main, [gt_path, traj_p, videos, out, *flags],
                len(drawn) * PLOT_FRAMES)
            if sorted(os.listdir(out)) != sorted(drawn):
                raise AssertionError(f"vis-multifuture: {os.listdir(out)}")
            for key in drawn:
                drawn_on("vis-multifuture %s" % key, [
                    os.path.join(out, key, "%08d.jpg" % i)
                    for i in range(len(os.listdir(os.path.join(out, key))))],
                    plain[key])
    out = os.path.join(root, "dataset")
    text = plot_main("mvt-torch-vis-dataset --drop_frame 2", card,
                     vis_dataset_cli.vis_dataset_main,
                     [videos, gt_path, out, "--drop_frame", "2"],
                     len(keys) * PLOT_FRAMES // 2)
    if text.strip() != "visualized %d obs groups" % len(keys):
        raise AssertionError(f"vis-dataset: {text!r}")
    for key in keys:
        drawn_on("vis-dataset %s" % key, [
            os.path.join(out, key, "%08d.jpg" % i)
            for i in range(len(os.listdir(os.path.join(out, key))))],
            plain[key][::2])


def plot_test_outputs(root: str, card: str, prep: str) -> dict:
    """(b): mvt-torch-test --save_output on phase 12's trained run, greedy
    and with the beam decode (K1 batches x T each, the beam decode as
    many again), then mvt-torch-vis-grid on each pickle and
    mvt-torch-vis-output on both as two runs. Returns K1's launches."""
    import cv2

    cfg = train_config()
    prepro = os.path.join(prep, "prepro")
    with np.load(os.path.join(prepro, "data_test.npz"),
                 allow_pickle=True) as d:
        n_test = len(d["obs_traj"])
    batches = -(-n_test // cfg.batch_size)
    pickles, k1 = {}, 0
    for mode, flags in (("greedy", []), ("beam", PLOT_BEAM_FLAGS)):
        pickles[mode] = os.path.join(root, "%s.p" % mode)
        reset_launches()
        t0 = time.perf_counter()
        perf = test_cli.main([prepro, os.path.join(prep, "out"), "prepared",
                              "--save_output", pickles[mode],
                              *TP_TEST_FLAGS, *flags])
        torch.cuda.synchronize()
        ran = decode_step_gathered.launches
        want = batches * cfg.pred_len * (2 if flags else 1)
        print("plotting phase: mvt-torch-test --save_output %s on the %d "
              "test examples in %.3f s (load included): grid0_traj_ade "
              "%.4f; K1 ran %d times (%d batches x T %d%s)"
              % (mode, n_test, time.perf_counter() - t0,
                 perf["grid0_traj_ade"], ran, batches, cfg.pred_len,
                 ", eval and beam decode" if flags else ""))
        if ran != want or not np.isfinite(perf["grid0_traj_ade"]):
            raise AssertionError(f"mvt-torch-test {mode}: K1 {ran}, "
                                 f"want {want}; {perf}")
        k1 += ran
    with open(pickles["greedy"], "rb") as f:
        data = pickle.load(f)
    with open(pickles["beam"], "rb") as f:
        beam = pickle.load(f)
    seq_ids = [str(s).rsplit("_", 2) for s in data["seq_ids"]]
    if len(seq_ids) != n_test or [str(s) for s in beam["seq_ids"]] \
            != [str(s) for s in data["seq_ids"]] \
            or np.asarray(beam["beam_grid_ids"]).shape \
            != (n_test, PLOT_BEAMS, cfg.pred_len):
        raise AssertionError("mvt-torch-test's pickles")
    video = seq_ids[0][0]
    chosen = []
    for v, fr, _ in seq_ids:
        if v == video and int(fr) not in chosen:
            chosen.append(int(fr))
    chosen = chosen[:PLOT_GRID_FRAMES]
    # the leading examples on the chosen frames (the test split holds
    # them first): vis-grid reads no frame it was not given
    end = next((i for i, (v, fr, _) in enumerate(seq_ids)
                if v != video or int(fr) not in chosen), len(seq_ids))
    frames = os.path.join(root, "frames", video)
    os.makedirs(frames)
    last_obs = (cfg.obs_len - 1) * 12
    plain = {}
    for k, fr in enumerate(chosen):
        for at in (fr, fr + last_obs):
            if at not in plain:
                plain[at] = plot_image(100 + at)
                cv2.imwrite(os.path.join(frames, "%s_F_%08d.jpg"
                                         % (video, at)), plain[at])
    # what the commands read back from those jpgs
    plain = {at: cv2.imread(os.path.join(frames, "%s_F_%08d.jpg"
                                         % (video, at))) for at in plain}
    for mode, flags in (("greedy", []),
                        ("beam", PLOT_BEAM_FLAGS[:3])):
        out = os.path.join(root, "grid_" + mode)
        text = plot_main("mvt-torch-vis-grid %s" % mode, card,
                         vis_grid_cli.main,
                         [pickles[mode], out, os.path.dirname(frames),
                          "--vis_end", str(end), *flags], len(chosen))
        if text.splitlines()[-1] != "wrote %d frames" % len(chosen):
            raise AssertionError(f"vis-grid {mode}: {text!r}")
        drawn_on("vis-grid %s" % mode, [
            os.path.join(out, video, "%s_F_%08d.jpg" % (video, fr))
            for fr in chosen], [plain[fr + last_obs] for fr in chosen])
    outlist = os.path.join(root, "outlist.txt")
    with open(outlist, "w") as f:
        f.write("%s,0_0_255\n%s,255_128_0\n" % (pickles["greedy"],
                                                 pickles["beam"]))
    with_frames = [i for i, (v, fr, _) in enumerate(seq_ids)
                   if v == video and int(fr) in plain]
    for flags, n in ((["--ordered", "--vis_num", str(PLOT_OUTPUT_NUM)],
                      PLOT_OUTPUT_NUM),
                     (["--use_heatmap", "--vis_num", str(PLOT_OUTPUT_HEAT)],
                      PLOT_OUTPUT_HEAT)):
        n = min(n, len(with_frames))
        out = os.path.join(root, "output" + flags[0].replace("-", "_"))
        text = plot_main("mvt-torch-vis-output %s (greedy and beam runs)"
                         % " ".join(flags), card, vis_output_cli.main,
                         [outlist, os.path.dirname(frames), out, *flags], n,
                         "images")
        if text.strip() != "wrote %d visualizations" % n:
            raise AssertionError(f"vis-output: {text!r}")
        names = sorted(os.listdir(out))
        drawn_on("vis-output", [os.path.join(out, name) for name in names],
                 [plain[int(name[:-4].rsplit("_", 2)[1])] for name in names])
    return {"K1": k1}


def plot_host_commands(root: str, card: str, tmp: str) -> None:
    """(c): mvt-torch-vis-real-data on phase 12's pixel and world TSVs
    (with and without --h_file), mvt-torch-vis-sdd-annotation on its
    prepared SDD files, and the CARLA conversions of its world TSVs."""
    import cv2

    host = os.path.join(tmp, "prep_host")
    # the pixel and world TSVs of phase 12's mvt-torch-combine-traj
    # --is_actev run
    pixel_dir = os.path.join(host, "combined_5")
    world_dir = os.path.join(host, "combined_world")
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(world_dir))
    name = next(n for n in names
                if fp_moments.get_scene(n) == PREP_ANCHOR_SCENES["test"])
    with open(os.path.join(pixel_dir, name + ".txt")) as f:
        start = min(int(float(line.split("\t")[0])) for line in f)
    frame_file = os.path.join(root, "real_frames", name,
                              "%s_F_%08d.jpg" % (name, start))
    os.makedirs(os.path.dirname(frame_file))
    cv2.imwrite(frame_file, plot_image(7))
    for flags in ([], ["--h_file", os.path.join(
            host, "homography", fp_moments.get_scene(name) + ".txt"),
            "--world_rotate", "30"]):
        vis = os.path.join(root, "real_%d" % len(flags), name + ".jpg")
        text = plot_main("mvt-torch-vis-real-data%s" % (
            " --h_file --world_rotate 30" if flags else ""), card,
            vis_real_cli.main,
            [os.path.join(root, "real_frames"), str(start),
             os.path.join(pixel_dir, name + ".txt"),
             os.path.join(world_dir, name + ".txt"), vis, *flags], 1)
        img = cv2.imread(vis)
        if text.strip() != "wrote %s" % vis \
                or img.shape != (PLOT_H, 2 * PLOT_W, 3):
            raise AssertionError(f"vis-real-data: {text!r}")

    sdd = os.path.join(host, "sdd_prepared")
    sdd_frames = os.path.join(root, "sdd_frames")
    n_frames = 0
    for split in os.listdir(os.path.join(sdd, "traj_2.5fps")):
        for traj in os.listdir(os.path.join(sdd, "traj_2.5fps", split)):
            vid = os.path.splitext(traj)[0]
            seen = []
            with open(os.path.join(sdd, "traj_2.5fps", split, traj)) as f:
                for line in f:
                    fr = int(line.split("\t")[0])
                    if fr not in seen:
                        seen.append(fr)
                    if len(seen) == 3:
                        break
            os.makedirs(os.path.join(sdd_frames, vid))
            for fr in seen:
                cv2.imwrite(os.path.join(sdd_frames, vid, "%s_F_%08d.jpg"
                                         % (vid, fr)), plot_image(fr))
            n_frames += len(seen)
    out = os.path.join(root, "sdd_vis")
    text = plot_main("mvt-torch-vis-sdd-annotation", card,
                     vis_annotation_cli.vis_sdd_annotation_main,
                     [sdd, sdd_frames, out], n_frames)
    written = sum(len(os.listdir(os.path.join(out, d)))
                  for d in os.listdir(out))
    if text.strip() != "wrote %d annotated frames" % written or not written:
        raise AssertionError(f"vis-sdd-annotation: {text!r}, {written}")

    scene = fp_moments.get_scene(name)
    calib = fp_moments.GROUND_CALIBRATIONS[scene]
    with open(os.path.join(world_dir, name + ".txt")) as f:
        n_rows = len(f.readlines())
    for flags in ([], ["--is_actev"]):
        dst = os.path.join(root, "carla_%d.txt" % len(flags))
        text = plot_main("mvt-torch-plot-traj-carla --save_carla_traj_file"
                         + (" --is_actev" if flags else ""), card,
                         vis_annotation_cli.plot_traj_carla_main,
                         [os.path.join(world_dir, name + ".txt"),
                          *(str(v) for v in calib["origin"]),
                          str(calib["carla_rotate"]), "--world_rotate",
                          str(calib["world_rotate"]),
                          "--save_carla_traj_file", dst, *flags], n_rows,
                         "rows")
        got = np.loadtxt(dst, ndmin=2)
        if text.strip() != "saved %s" % dst or got.shape != (n_rows, 5) \
                or not np.isfinite(got).all():
            raise AssertionError(f"plot-traj-carla: {text!r}")
    # ActEV: phase 12's world TSVs and a copy under a scene-0002 name,
    # which the command skips; vehicles for two of them
    actev, veh = os.path.join(root, "actev_world"), \
        os.path.join(root, "actev_vehicle")
    shutil.copytree(world_dir, actev)
    os.makedirs(veh)
    shutil.copy(os.path.join(world_dir, name + ".txt"),
                os.path.join(actev, "VIRAT_S_000200_00.txt"))
    for n in names[:2]:
        shutil.copy(os.path.join(world_dir, n + ".txt"), veh)
    n_rows = sum(1 for n in os.listdir(actev)
                 for _ in open(os.path.join(actev, n)))
    for mode, args, done in (
            ("ActEV", [actev, os.path.join(root, "carla_actev"),
                       "--traj_vehicle_world_path", veh,
                       "--save_carla_vehicle_path",
                       os.path.join(root, "carla_vehicle")],
             "converted %d files (1 skipped)" % len(names)),
            ("ETH/UCY", [world_dir, os.path.join(root, "carla_ethucy")],
             "converted %d files (0 skipped)" % len(names))):
        text = plot_main("mvt-torch-batch-plot-traj-carla (%s)" % mode, card,
                         vis_annotation_cli.batch_plot_traj_carla_main, args,
                         n_rows, "rows")
        if text.strip() != "%s -> %s" % (done, args[1]) \
                or sorted(os.listdir(args[1])) != sorted(
                    n + ".txt" for n in names):
            raise AssertionError(f"batch-plot-traj-carla {mode}: {text!r}")
    if sorted(os.listdir(os.path.join(root, "carla_vehicle"))) \
            != sorted(n + ".txt" for n in names[:2]):
        raise AssertionError("batch-plot-traj-carla: the vehicle files")


def plotting_phase(tmp: str, card: str) -> dict:
    """Phase 14 (see the module docstring), in phase 12's temporary
    directory. Returns K1's launches."""
    import cv2
    import scipy

    print("plotting phase: cv2 %s, scipy %s" % (cv2.__version__,
                                                 scipy.__version__))
    t0 = time.perf_counter()
    root = os.path.join(tmp, "plot")
    os.makedirs(root)
    prep = os.path.join(tmp, "prep")
    plot_multifuture(root, card, prep)
    launches = plot_test_outputs(root, card, prep)
    plot_host_commands(root, card, tmp)
    print("plotting phase (%s): %.3f s whole (host figures of the card's "
          "machine)" % (card, time.perf_counter() - t0))
    return launches


# ------------------------------------------------------ recorded moments

# phase 15: moments recorded through the fake CARLA backend
# (tests/torch_fake_carla.py) at the published 1920x1080 frame size, then
# the Forking Paths chain on what was recorded. REC_SCENE is an ETH/UCY
# scene (25 fps; the multi-future obs starts at frame 32, every 10th
# frame): a walk of REC_FRAMES frames gives obs 8 + pred 12. REC_OBS_KEYS
# moments x REC_FUTURES futures of an x-agent (pid 1) beside a second
# pedestrian (pid 2), seen by a straight-down rig from a registry in the
# temporary directory; the x-agent turns its own way after REC_DIVERGE.
# One more recording of the packaged registry's anchor rig
# (--is_anchor_moment, obs 8 + pred 13 at 2.5 of 25 fps: 200 frames, 20
# sampled, one obs 8 + pred 12 window a walker). Each recording is one
# mvt-torch-record-moments process, all five at once.
REC_SCENE, REC_FPS, REC_W, REC_H = "zara01", 25.0, 1920, 1080
REC_FRAMES, REC_DIVERGE = 231, 102
REC_OBS_KEYS, REC_FUTURES = 2, 2
REC_ANCHOR_OBS, REC_ANCHOR_PRED = 8, 13
REC_TRAIN_FLAGS = list(PREP_TRAIN_FLAGS)
REC_TRAIN_FLAGS[REC_TRAIN_FLAGS.index("--num_epochs") + 1] = "2"
# the SegFormer phase 15 builds where transformers imports (random
# weights, a small SegformerConfig) and the frames it segments
REC_SEGFORMER_FRAMES = 8
# segment_images with the numpy segmenter reads every REC_SEG_EVERY-th
# recorded frame
REC_SEG_EVERY = 4
REC_SEGFORMER_DEVICES = ("cuda", "cpu")
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def rec_walk(m: int, dy: float, start: tuple = (-6.0, 0.0),
             frames: int = REC_FRAMES, diverge: int = REC_DIVERGE,
             speed: float = 0.05) -> list:
    """Trajectory rows (frame, pid, x, y, z) every 10th frame: pid 1
    walks along x and turns by ``dy`` m after ``diverge``; pid 2 walks
    1.5 m beside it. Moment ``m`` starts 3 m further along y."""
    rows = []
    for f in range(0, frames, 10):
        x = start[0] + speed * f
        y = start[1] - 3.0 * m + (
            0.0 if f <= diverge else dy * (f - diverge) / (frames - diverge))
        rows.append((f, 1, x, y, 0.5))
        rows.append((f, 2, x - 1.0, y + 1.5, 0.5))
    return rows


def anchor_ground_point(rig) -> tuple:
    """Where the centre ray of ``rig`` meets the walkers' plane z = 0.5."""
    from multiverse_torch.forking_paths import camera

    eye = np.array([rig.transform.x, rig.transform.y, rig.transform.z])
    ray = camera.pixel_to_world(rig.width / 2, rig.height / 2, 1.0, rig) - eye
    t = (0.5 - eye[2]) / ray[2]
    return tuple(eye[:2] + t * ray[:2])


def record_process(argv: list):
    """Start one mvt-torch-record-moments run over the fake backend in
    a process of its own."""
    code = ("import sys; sys.path.insert(0, %r); import torch_fake_carla; "
            "torch_fake_carla.install(); from multiverse_torch.cli import "
            "vis_dataset; vis_dataset.record_moments_main(%r)"
            % (TESTS_DIR, argv))
    return subprocess.Popen([sys.executable, "-c", code],
                            cwd=os.path.dirname(TESTS_DIR),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def rec_write_moments(root: str) -> dict:
    """The registry, the moment JSONs (one a recording), the anchor
    moment and a trajectory file of the first moment's walk."""
    from multiverse_torch.forking_paths import scenes

    registry = {
        "scenes": {REC_SCENE: {"map": "Town03_ethucy", "fps": REC_FPS,
                               "static_cars": [], "weather": {}}},
        "cameras": {"recording": {REC_SCENE: [
            {"fov": 90.0, "location_xyz": [0.0, 0.0, 18.0],
             "rotation_pyr": [-90.0, 0.0, 0.0],
             "width": REC_W, "height": REC_H}]}}}
    out = {"registry": os.path.join(root, "registry.json"), "argv": [],
           "mf": [], "obs_keys": []}
    with open(out["registry"], "w") as f:
        json.dump(registry, f)
    ds = os.path.join(root, "dataset")
    for m in range(REC_OBS_KEYS):
        out["obs_keys"].append("%s_%d_1_cam1" % (REC_SCENE, m))
        for d in range(REC_FUTURES):
            rows = rec_walk(m, 2.0 * (d - (REC_FUTURES - 1) / 2))
            controls, _ = fp_controls.traj_to_controls(
                np.asarray(rows, np.float64), -1, -1, REC_FPS)
            mid = "%s_%d_1_%d_%s" % (REC_SCENE, m, d, "ab"[d])
            path = os.path.join(root, mid + ".json")
            with open(path, "w") as f:
                json.dump([{"scenename": REC_SCENE, "moment_id": mid,
                            "ped_controls": controls,
                            "vehicle_controls": {},
                            "x_agents": {"1": []}}], f, default=float)
            out["argv"].append([path, ds, "--scene_registry",
                                out["registry"]])
            out["mf"].append(mid + "_cam1")
            if m == 0 and d == 0:
                traj_dir = os.path.join(root, "traj")
                os.makedirs(traj_dir)
                out["traj"] = os.path.join(traj_dir, REC_SCENE + ".txt")
                with open(out["traj"], "w") as f:
                    f.writelines("%d\t%d\t%.3f\t%.3f\t%.3f\n" % r
                                 for r in rows)
    rig = scenes.load_default_registry().cameras["anchor"][REC_SCENE][0]
    frames = (REC_ANCHOR_OBS + REC_ANCHOR_PRED - 1) * 10 + 1
    rows = rec_walk(0, 0.0, start=anchor_ground_point(rig), frames=frames,
                    diverge=frames, speed=0.01)
    controls, _ = fp_controls.traj_to_controls(np.asarray(rows, np.float64),
                                               -1, -1, REC_FPS)
    path = os.path.join(root, "anchor.json")
    with open(path, "w") as f:
        json.dump([{"scenename": REC_SCENE, "filename": REC_SCENE,
                    "original_start_frame_id": 0, "ped_controls": controls,
                    "vehicle_controls": {}}], f, default=float)
    out["argv"].append([path, ds, "--is_anchor_moment", "--video_fps",
                        str(REC_FPS), "--annotation_fps", "2.5",
                        "--obs_length", str(REC_ANCHOR_OBS),
                        "--pred_length", str(REC_ANCHOR_PRED)])
    out["anchor"] = "%s_F_0_obs%d_pred%d_cam1" % (REC_SCENE, REC_ANCHOR_OBS,
                                                  REC_ANCHOR_PRED)
    out["ds"] = ds
    return out


def rec_record(root: str, card: str) -> dict:
    """(1) Every recording in parallel processes, then the two moment
    commands on the first walk's trajectory file."""
    inp = rec_write_moments(root)
    t0 = time.perf_counter()
    procs = [record_process(argv) for argv in inp["argv"]]
    runs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            runs.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError("mvt-torch-record-moments failed "
                                     "(exit %d):\n%s"
                                     % (proc.returncode, out[-4000:]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    dt = time.perf_counter() - t0
    names = inp["mf"] + [inp["anchor"]]
    frames = 0
    for name in names:
        need_files("mvt-torch-record-moments", [
            os.path.join(inp["ds"], sub, name + ext) for sub, ext in (
                ("videos", ".mp4"), ("videos_seg", ".mp4"),
                ("bbox", ".json"))])
        data = prepared_data.load_frame_data(
            os.path.join(inp["ds"], "bbox", name + ".json"))
        tracks = {b["track_id"] for boxes in data.values() for b in boxes}
        if tracks != {1.0, 2.0}:
            raise AssertionError(f"{name}: boxes of tracks {tracks}")
        frames += len(data)
    print("recorded-moment phase (%s): mvt-torch-record-moments, %d "
          "recordings at %dx%d, one process each: %.3f s, %d frames (rgb + "
          "seg), %.1f frames/s; processes done at %s s (host)"
          % (card, len(runs), REC_W, REC_H, dt, frames, frames / dt,
             [round(r, 3) for r in runs]))

    from multiverse_torch.cli import moment_tools

    sys.path.insert(0, TESTS_DIR)
    import torch_fake_carla

    torch_fake_carla.install()
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            moment_tools.build_moment_main([
                inp["traj"], "0", str(REC_FRAMES - 1), "--scene_registry",
                inp["registry"]])
        dt = time.perf_counter() - t0
        if "replay OK" not in buf.getvalue():
            raise AssertionError(f"build-moment: {buf.getvalue()}")
        print("recorded-moment phase (%s): mvt-torch-build-moment of %d "
              "frames: %.3f s, %.1f frames/s (host): %s"
              % (card, REC_FRAMES, dt, REC_FRAMES / dt,
                 buf.getvalue().strip().splitlines()[-1]))
        cand = os.path.join(root, "candidates")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            moment_tools.auto_candidates_main([
                os.path.dirname(inp["traj"]), cand, "--scene_registry",
                inp["registry"], "--moment_length", "4.0", "--test_skip",
                "5"])
        dt = time.perf_counter() - t0
        with open(os.path.join(cand, REC_SCENE + ".json")) as f:
            found = json.load(f)
        if not found or any(not c["ped_controls"] for c in found):
            raise AssertionError(f"auto-moment-candidates: {found}")
        print("recorded-moment phase (%s): mvt-torch-auto-moment-candidates"
              ": %.3f s, %d candidates (host): %s"
              % (card, dt, len(found), buf.getvalue().strip()))
    finally:
        sys.modules.pop("carla", None)
    inp["names"] = names
    return inp


def rec_prepare(root: str, inp: dict, card: str) -> dict:
    """(2) Frames and 36x64 scene class maps from the recordings, the
    multi-future and anchor splits, mvt-torch-preprocess."""
    cfg = train_config()
    ds = inp["ds"]
    out = {k: os.path.join(root, k) for k in (
        "frames", "mf_scene", "train_scene", "obs", "mf", "anchor",
        "prepro")}
    # one extract_frames_and_seg call a video and a window: (video,
    # frame ids, scene directory, name, start); the calls run on threads
    # (cv2 decodes outside the GIL)
    jobs = []
    for key, first in zip(inp["obs_keys"], inp["mf"][::REC_FUTURES]):
        data = prepared_data.load_frame_data(
            os.path.join(ds, "bbox", first + ".json"))
        needed = sorted(data)[32::10]
        if len(needed) != cfg.seq_len:
            raise AssertionError(f"{first}: {len(needed)} sampled frames")
        jobs.append((first, needed[:cfg.obs_len], out["mf_scene"], key, 32))
    windows = 0
    for name in inp["names"]:
        data = prepared_data.load_frame_data(
            os.path.join(ds, "bbox", name + ".json"))
        ids = sorted(data)[::10]
        windows += (len(ids) - cfg.seq_len + 1) * 2
        jobs.append((name, ids, out["train_scene"], name, 0))

    def extract(job) -> bool:
        video, ids, scene_dir, name, start = job
        return prepared_data.extract_frames_and_seg(
            os.path.join(ds, "videos", video + ".mp4"),
            os.path.join(ds, "videos_seg", video + ".mp4"), ids,
            out["frames"], os.path.join(scene_dir, name), name, start=start,
            scene_h=cfg.scene_h, scene_w=cfg.scene_w)

    import concurrent.futures

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(extract, jobs))
    if not all(done):
        raise AssertionError("extract_frames_and_seg: %s" % [
            j[3] for j, ok in zip(jobs, done) if not ok])
    n = sum(len(j[1]) for j in jobs)
    dt = time.perf_counter() - t0
    segs = [np.load(os.path.join(d, f))
            for where in (out["mf_scene"], out["train_scene"])
            for d, _, fs in os.walk(where) for f in fs]
    if len(segs) != n or any(s.shape != (cfg.scene_h, cfg.scene_w)
                             or not (s == 13).all() for s in segs):
        raise AssertionError("the recorded seg videos did not decode to "
                             "ADE20k person (13) maps of 36x64")
    print("recorded-moment phase (%s): extract_frames_and_seg of %d "
          "recordings, %d calls on threads: %.3f s, %d frames + class maps, "
          "%.1f frames/s (host)"
          % (card, len(inp["names"]), len(jobs), dt, n, n / dt))
    id2name = os.path.join(root, "scene_id2name.json")
    # the top classes the published scene_class keeps, person (13) first
    classes = [13] + [c for c in range(1, cfg.scene_class) if c != 13]
    with open(id2name, "w") as f:
        json.dump({"oldid2new": {str(c): i + 1 for i, c in enumerate(
            classes[:cfg.scene_class - 1])}, "id2name": {
                str(i + 1): "ade%d" % c for i, c in enumerate(
                    classes[:cfg.scene_class - 1])}}, f)

    t0 = time.perf_counter()
    stats = prepared_data.prepare_multifuture_split(
        ds, inp["mf"], out["obs"], out["mf"], "test",
        obs_length=cfg.obs_len)
    if stats["skipped"] or stats["num_obs"] != REC_OBS_KEYS:
        raise AssertionError(f"prepare_multifuture_split: {stats}")
    for key in inp["obs_keys"]:
        with open(os.path.join(out["mf"], "test", key + ".p"), "rb") as f:
            gt = pickle.load(f)
        if [len(g["x_agent_traj"]) for g in gt.values()] \
                != [cfg.pred_len] * REC_FUTURES:
            raise AssertionError(f"{key}: GT futures")
    for split in ("train", "val", "test"):
        prepared_data.prepare_anchor_split(ds, inp["names"], out["anchor"],
                                           split, drop_frame=10)
    print("recorded-moment phase (%s): prepare_multifuture_split + "
          "prepare_anchor_split: %.3f s (host)"
          % (card, time.perf_counter() - t0))
    t0 = time.perf_counter()
    preprocess_cli.main([os.path.join(out["anchor"], "traj_2.5fps"),
                         out["prepro"], "--scene_feat_path",
                         out["train_scene"], "--scene_id2name", id2name,
                         *PREPRO_FLAGS])
    dt = time.perf_counter() - t0
    print("recorded-moment phase (%s): mvt-torch-preprocess: %.3f s, %d "
          "examples in 3 splits, %.1f examples/s (host)"
          % (card, dt, 3 * windows, 3 * windows / dt))
    for split in ("train", "val", "test"):
        with np.load(os.path.join(out["prepro"], "data_%s.npz" % split),
                     allow_pickle=True) as d:
            if len(d["obs_traj"]) != windows:
                raise AssertionError(f"preprocess {split}: "
                                     f"{len(d['obs_traj'])} examples")
    out.update(id2name=id2name, windows=windows)
    return out


def rec_train_decode(root: str, inp: dict, out: dict, card: str) -> dict:
    """(3) Two epochs of mvt-torch-train at the published flags on the
    recorded data, the K = 20 bf16 and int8a decodes of its obs and
    both evaluators. Returns the launches of K1, K3, K4 and K5."""
    cfg = train_config()
    rec = StepRecorder(parallel.make_sharded_train_step)
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(train_cli, "make_sharded_train_step", rec):
        result = train_cli.main([out["prepro"], os.path.join(root, "runs"),
                                 "recorded", *REC_TRAIN_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(rec.losses).float().cpu().numpy()
    launches = {"K4": gnn_dense_fwd.launches, "K5": gnn_dense_bwd.launches,
                "K1": decode_step_gathered.launches, "K3": 0}
    steps = result["steps"]
    per_epoch = -(-out["windows"] // cfg.batch_size)
    print("recorded-moment phase (%s): mvt-torch-train 2 epochs, %d steps "
          "in %.3f s (%.1f examples/s, evals and saves included); losses "
          "%s; launches K4 %d, K5 %d, eval K1 %d"
          % (card, steps, wall, steps * cfg.batch_size / wall,
             np.round(losses, 4).tolist(), launches["K4"], launches["K5"],
             launches["K1"]))
    if steps != 2 * per_epoch or len(losses) != steps \
            or not np.isfinite(losses).all() \
            or launches["K4"] != steps * cfg.pred_len \
            or launches["K5"] != steps * cfg.pred_len \
            or launches["K1"] != per_epoch * cfg.pred_len:
        raise AssertionError(f"recorded-moment train: {steps} steps, "
                             f"losses {losses}, launches {launches}")
    run = os.path.join(root, "runs", "recorded", "00")
    obs = os.path.join(out["obs"], "traj_2.5fps", "test")
    mf = os.path.join(out["mf"], "test")
    for tier, kernel in (("none", "K1"), ("int8a", "K3")):
        traj_p = os.path.join(root, "%s.traj.p" % tier)
        prob_p = os.path.join(root, "%s.prob.p" % tier)
        reset_launches()
        t0 = time.perf_counter()
        inference_cli.main([os.path.join(run, "save"), obs, mf, traj_p,
                            "--save_prob_file", prob_p, "--decode_quant",
                            tier, "--scene_feat_path", out["mf_scene"],
                            "--scene_id2name", out["id2name"],
                            *PREP_DECODE_FLAGS])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran = tier_launches(tier)
        batches = -(-REC_OBS_KEYS // 16)
        if ran != batches * cfg.pred_len:
            raise AssertionError(f"recorded-moment {tier} decode: {kernel} "
                                 f"ran {ran} times")
        launches[kernel] += ran
        with open(traj_p, "rb") as f:
            trajs = pickle.load(f)
        if sorted(trajs) != sorted(inp["obs_keys"]) or any(
                np.asarray(t).shape != (20, cfg.pred_len, 2)
                or not np.isfinite(np.asarray(t)).all()
                for t in trajs.values()):
            raise AssertionError(f"the recorded-moment {tier} pickles")
        ade_fde = scores(eval_trajs_cli.main, [mf, traj_p])
        nll = scores(eval_prob_cli.main, [mf, prob_p])
        print("recorded-moment phase (%s): mvt-torch-multifuture-inference "
              "%s K = 20 on the %d recorded obs: %.3f s (load included), %s "
              "ran %d times (%d batches x T %d); minADE/minFDE %s, NLL %s"
              % (card, tier, REC_OBS_KEYS, dt, kernel, ran, batches,
                 cfg.pred_len, ade_fde, nll))
        if len(ade_fde) != 6 or len(nll) != 5 \
                or not np.isfinite([ade_fde[i] for i in (0, 2, 3, 5)]
                                   + nll).all():
            raise AssertionError(f"the recorded-moment {tier} scores")
    return launches


def rec_numpy_segmenter(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.int32).sum(axis=2) % 11).astype(np.uint8)


def rec_scene_seg(root: str, frames: list, card: str) -> None:
    """(4) mvt-torch-extract-scene-seg's segment_images over the recorded
    RGB frames with a fixed numpy segmenter; every npy checked."""
    import cv2

    from multiverse_torch.data import scene_extract

    t0 = time.perf_counter()
    written = scene_extract.segment_images(
        frames, rec_numpy_segmenter, os.path.join(root, "seg_numpy"),
        save_two_level=True)
    dt = time.perf_counter() - t0
    if len(written) != len(frames):
        raise AssertionError("segment_images wrote %d of %d"
                             % (len(written), len(frames)))
    for img_file, npy in zip(frames, written):
        want = scene_extract.resize_seg_map(rec_numpy_segmenter(
            cv2.cvtColor(cv2.imread(img_file), cv2.COLOR_BGR2RGB)), 8.0)
        got = np.load(npy)
        if got.dtype != np.uint8 or got.shape != want.shape \
                or not np.array_equal(got, want):
            raise AssertionError(f"segment_images: {npy}")
    print("recorded-moment phase (%s): segment_images (numpy segmenter) of "
          "%d recorded %dx%d frames: %.3f s, %.1f frames/s (host)"
          % (card, len(frames), REC_W, REC_H, dt, len(frames) / dt))


OPTIONAL_ABSENT = 3


def optional_worker(package: str, root: str, imglst: str) -> int:
    """A subprocess of phase 15 that runs what needs one optional host
    package: ``tensorflow`` (mvt-torch-extract-scene-seg on a one-op
    DeepLab graph, the card hidden), ``transformers`` (the same command
    on a random SegFormer, on cuda and on cpu) or ``pygame`` (the
    spectator and the moment editor over the fake backend, SDL's dummy
    driver). Returns OPTIONAL_ABSENT, having printed why, where the
    package does not import; raises on any other failure."""
    for name in ("jax", "jaxlib", "multiverse_tpu"):
        sys.modules[name] = None
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    try:
        mod = importlib.import_module(package)
        if package == "transformers":
            # the SegFormer backend's image processor has optional
            # packages of its own (torchvision, from transformers 5)
            mod.SegformerImageProcessor()
    except ImportError as e:
        print("recorded-moment phase: %s, or a package it needs here, does "
              "not import on this host: %s" % (package, " ".join(
                  str(e).split())))
        return OPTIONAL_ABSENT
    print("recorded-moment phase: %s %s" % (package,
                                            getattr(mod, "__version__", "")))
    if package == "transformers":
        # started beside the training: the card is ours from this line on
        sys.stdin.readline()
    with open(imglst) as f:
        frames = [line.strip() for line in f if line.strip()]
    if package == "tensorflow":
        rec_deeplab(mod, root, imglst, frames)
    elif package == "transformers":
        rec_segformer(root, imglst, frames)
    else:
        rec_pygame(root)
    return 0


def rec_deeplab(tf, root: str, imglst: str, frames: list) -> None:
    import cv2

    graph = tf.Graph()
    with graph.as_default():
        image = tf.compat.v1.placeholder(tf.uint8, [1, None, None, 3],
                                         name="ImageTensor")
        tf.argmax(image, axis=3, name="SemanticPredictions")
    pb = os.path.join(root, "deeplab_one_op.pb")
    with open(pb, "wb") as f:
        f.write(graph.as_graph_def().SerializeToString())
    out = os.path.join(root, "seg_deeplab")
    t0 = time.perf_counter()
    prepare_cli.extract_scene_seg_main([imglst, pb, out])
    dt = time.perf_counter() - t0
    for img_file in frames:
        name = os.path.splitext(os.path.basename(img_file))[0]
        got = np.load(os.path.join(out, name + ".npy"))
        img = cv2.imread(img_file)
        if got.shape != (img.shape[0] // 8, img.shape[1] // 8) \
                or got.max() > 2:
            raise AssertionError(f"the DeepLab graph's map of {name}")
    print("recorded-moment phase: mvt-torch-extract-scene-seg, one-op "
          "DeepLab graph (tensorflow, host): %d frames in %.3f s, %.3f s a "
          "frame (host)" % (len(frames), dt, dt / len(frames)))


def rec_segformer(root: str, imglst: str, frames: list) -> None:
    from transformers import (
        SegformerConfig,
        SegformerForSemanticSegmentation,
        SegformerImageProcessor,
    )

    path = os.path.join(root, "segformer")
    torch.manual_seed(0)
    SegformerForSemanticSegmentation(SegformerConfig(
        num_encoder_blocks=2, depths=[1, 1], sr_ratios=[2, 1],
        hidden_sizes=[16, 32], num_attention_heads=[1, 2],
        decoder_hidden_size=32, num_labels=150, patch_sizes=[7, 3],
        strides=[4, 2], mlp_ratios=[2, 2])).eval().save_pretrained(path)
    SegformerImageProcessor().save_pretrained(path)
    maps = {}
    for device in REC_SEGFORMER_DEVICES:
        out = os.path.join(root, "seg_segformer_" + device)
        # one frame first: the model's load and first call, untimed
        prepare_cli.extract_scene_seg_main([
            imglst, path, out + "_first", "--every", str(len(frames)),
            "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepare_cli.extract_scene_seg_main([imglst, path, out, "--device",
                                            device])
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        maps[device] = [np.load(os.path.join(out, os.path.splitext(
            os.path.basename(f))[0] + ".npy")) for f in frames]
        if any(m.dtype != np.uint8 or m.min() < 1 or m.max() > 150
               for m in maps[device]):
            raise AssertionError(f"SegFormer maps on {device}")
        print("recorded-moment phase: mvt-torch-extract-scene-seg, random "
              "SegFormer (transformers) on %s: %d frames in %.3f s, %.4f s "
              "a frame" % (device, len(frames), dt, dt / len(frames)))
    first, *others = REC_SEGFORMER_DEVICES
    for device in others:
        same = np.mean([np.mean(a == b) for a, b in zip(maps[first],
                                                         maps[device])])
        print("recorded-moment phase: SegFormer class maps on %s equal to "
              "those on %s in %.6f of pixels (information, not a gate)"
              % (first, device, same))


def rec_pygame(root: str) -> None:
    import pygame

    sys.path.insert(0, TESTS_DIR)
    import torch_fake_carla

    from multiverse_torch.forking_paths import interactive

    torch_fake_carla.install()
    shots = os.path.join(root, "spectator")
    t0 = time.perf_counter()
    interactive.spectator_main([
        "--width", str(REC_W), "--height", str(REC_H), "--go_to_anchor",
        REC_SCENE, "--save_screenshot_path", shots, "--max_ticks", "5"])
    dt = time.perf_counter() - t0
    print("recorded-moment phase: mvt-torch-spectator at %dx%d, 5 ticks "
          "(pygame %s, SDL dummy driver): %.3f s (host)"
          % (REC_W, REC_H, pygame.version.ver, dt))
    moments = []
    for name in sorted(os.listdir(root)):
        if name.startswith(REC_SCENE + "_") and name.endswith(".json"):
            with open(os.path.join(root, name)) as f:
                moments += json.load(f)
    client = sys.modules["carla"].Client()
    t0 = time.perf_counter()
    saved = interactive.run_moment_editor(
        client, moments, os.path.join(root, "edited.json"), width=REC_W,
        height=REC_H, max_ticks=5)
    dt = time.perf_counter() - t0
    if len(saved) != len(moments):
        raise AssertionError("moment editor: %d of %d moments saved"
                             % (len(saved), len(moments)))
    print("recorded-moment phase: the moment editor on the %d recorded "
          "moments at %dx%d, 5 ticks: %.3f s (host)"
          % (len(moments), REC_W, REC_H, dt))


def optional_process(package: str, root: str, imglst: str,
                     hide_card: bool):
    """Start :func:`optional_worker` for ``package`` in a subprocess."""
    env = dict(os.environ)
    if hide_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.optional_worker("
            "%r, %r, %r))" % (package, root, imglst))
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=os.path.dirname(
            os.path.abspath(__file__)), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def optional_result(package: str, proc, card: str, timeout: float) -> None:
    """Let ``proc`` (``optional_process``) go on, wait for it and print
    what it said; raises if it failed."""
    out, _ = proc.communicate("go\n", timeout=timeout)
    lines = [line for line in out.splitlines()
             if line.startswith("recorded-moment phase")]
    for line in lines:
        print(line.replace("recorded-moment phase:",
                           "recorded-moment phase (%s):" % card, 1))
    if proc.returncode == OPTIONAL_ABSENT:
        print("recorded-moment phase: not run: the %s part (%s), as %s or "
              "a package it needs does not import on this host" % (package, {
                  "tensorflow": "the one-op DeepLab graph",
                  "transformers": "the random SegFormer on cuda and cpu",
                  "pygame": "the spectator and the moment editor"}[package],
                  package))
    elif proc.returncode != 0:
        raise AssertionError("recorded-moment phase: the %s part failed "
                             "(exit %d):\n%s" % (package, proc.returncode,
                                                 out[-4000:]))


def recorded_moment_phase(dev, tmp: str, card: str) -> dict:
    """Phase 15 (see the module docstring). Returns the launches of K1,
    K3, K4 and K5."""
    import cv2

    t_phase = time.perf_counter()
    print("recorded-moment phase: cv2 %s" % cv2.__version__)
    root = os.path.join(tmp, "recorded")
    os.makedirs(root)
    inp = rec_record(root, card)
    out = rec_prepare(root, inp, card)
    frames = sorted(os.path.join(out["frames"], f)
                    for f in os.listdir(out["frames"]))
    imglst = os.path.join(root, "segformer_frames.lst")
    with open(imglst, "w") as f:
        f.write("\n".join(frames[:REC_SEGFORMER_FRAMES]) + "\n")
    # the optional packages' parts start now, the host ones run beside
    # the training; the transformers one imports beside it and waits
    host = {p: optional_process(p, root, imglst, p != "transformers")
            for p in ("tensorflow", "pygame", "transformers")}
    try:
        t0 = time.perf_counter()
        launches = rec_train_decode(root, inp, out, card)
        print("recorded-moment phase (%s): train + decodes + scores %.3f s"
              % (card, time.perf_counter() - t0))
        t0 = time.perf_counter()
        rec_scene_seg(root, frames[::REC_SEG_EVERY], card)
        for package, proc in host.items():
            optional_result(package, proc, card, 600)
        print("recorded-moment phase (%s): scene-seg and the optional "
              "packages' parts %.3f s" % (card, time.perf_counter() - t0))
    finally:
        for proc in host.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("recorded-moment phase (%s): %.3f s whole (host figures of the "
          "card's machine)" % (card, time.perf_counter() - t_phase))
    return launches


# ------------------------------------------------- convergence campaigns

# phase 16: both campaigns (multiverse_torch/campaign) at the published
# flags, cut only in data and epochs; run B of the flagship is SIGKILLed
# at the first save of epoch CAMP_EPOCHS // 2 and resumed. Every command
# a stage starts runs through ``chip_smoke.py --counted``, which appends
# its kernels' launches to a file when the command ends.
CAMP_EPOCHS = 4
CAMP_FLAGSHIP = ["--train_moments", "2", "--val_moments", "1",
                 "--test_moments", "1", "--mf_groups", "4",
                 "--epochs", str(CAMP_EPOCHS)]
CAMP_SIMAUG = ["--train_moments", "1", "--peds", "5", "--epochs", "2"]
COUNTED = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")


def counted_command(counts: str, module: str, argv: list) -> int:
    """``chip_smoke.py --counted <file> <module> <args>``: run
    ``module``'s ``main(args)`` in this process with every launch count
    at 0, then append one JSON line to ``file``: the module, its steps
    (a trainer's) and each kernel's launches. A process killed before
    its end appends nothing."""
    reset_launches()
    for fn in PATHLESS.values():
        fn.launches = 0
    result = None
    try:
        result = importlib.import_module(module).main(argv)
    finally:
        q8 = decode_step_gathered_q8.launches
        line = {"module": module,
                "steps": (result or {}).get("steps")
                if isinstance(result, dict) else None,
                "K1": decode_step_gathered.launches, "K2": q8["int8"],
                "K3": q8["int8a"], "K4": gnn_dense_fwd.launches,
                "K5": gnn_dense_bwd.launches,
                "K7": decode_step_gathered_q8dyn.launches,
                **{k: fn.launches for k, fn in PATHLESS.items()}}
        with open(counts, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


def campaign_stage(what: str, card: str, main, argv: list, log: str):
    """One stage of a campaign through its ``main``, its printed lines
    to ``log``; prints its seconds."""
    t0 = time.perf_counter()
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        main(argv)
    dt = time.perf_counter() - t0
    print("campaign phase (%s): %s %.3f s" % (card, what, dt))
    return dt


def read_counts(path: str) -> list:
    """The lines ``--counted`` commands appended to ``path`` so far."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def campaign_phase(dev, tmp: str, card: str) -> dict:
    """Phase 16 (see the module docstring). Returns the launches of K1,
    K3, K4 and K5."""
    flagship, simaug = camp_flagship, camp_simaug
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "campaign")
    os.makedirs(root)
    counts = os.path.join(root, "counts.jsonl")
    log = os.path.join(root, "stages.log")

    def counted(module):
        return [sys.executable, os.path.abspath(__file__), "--counted",
                counts, module]

    launches = dict.fromkeys(("K1", "K3", "K4", "K5"), 0)
    work = os.path.join(root, "flagship")
    common = ["--work", work, "--device", dev.type, *CAMP_FLAGSHIP]
    with mock.patch.object(flagship, "python_module", counted), \
            mock.patch.object(simaug, "python_module", counted):
        for stage in ("data", "train", "resume", "infer", "artifact"):
            start = len(read_counts(counts))
            campaign_stage("flagship " + stage, card, flagship.main,
                           [stage, *common, "--out",
                            os.path.join(root, "curve.json")], log)
            ran = read_counts(counts)[start:]
            for line in ran:
                print("campaign phase (%s): flagship %s: %s steps %s, "
                      "launches %s" % (card, stage, line["module"],
                                       line["steps"],
                                       {k: line[k] for k in COUNTED
                                        if line[k]}))
            campaign_launches(stage, ran, work, launches)
        with open(os.path.join(root, "curve.json")) as f:
            curve = json.load(f)
        campaign_checks(curve, work, card)
        tier_agreement(work, dev, card)

        swork = os.path.join(root, "simaug")
        start = len(read_counts(counts))
        for stage in ("data", "train", "artifact"):
            campaign_stage("simaug " + stage, card, simaug.main,
                           [stage, "--work", swork, "--device", dev.type,
                            *CAMP_SIMAUG, "--out",
                            os.path.join(root, "simaug_curve.json")], log)
        (line,) = read_counts(counts)[start:]
        with open(os.path.join(swork, "meta.json")) as f:
            spe = json.load(f)["steps_per_epoch"]
        # the attack's tower pass and the outer one, a grid scale each
        want = line["steps"] * 12 * 2 * grid_scales(simaug.SIMAUG_MODEL)
        print("campaign phase (%s): simaug train %d steps, launches %s "
              "(K4, K5 want steps x 12 x 2 = %d)"
              % (card, line["steps"], {k: line[k] for k in COUNTED
                                       if line[k]}, want))
        if line["steps"] != 2 * spe or line["K4"] != want \
                or line["K5"] != want or not line["K1"]:
            raise AssertionError(f"the simaug campaign's launches: {line}")
        for k in launches:
            launches[k] += line[k]
    with open(os.path.join(root, "simaug_curve.json")) as f:
        sim = json.load(f)
    conv = sim["convergence"]
    print("campaign phase (%s): simaug convergence %s" % (card,
                                                          json.dumps(conv)))
    if not (np.isfinite([conv["first_eval"], conv["final_eval"],
                         conv["loss_first"], conv["loss_final"]]).all()
            and len(sim["curve"]) == 2):
        raise AssertionError(f"the simaug campaign's curve: {sim['curve']}")
    print("campaign phase (%s): launches %s; %.3f s whole"
          % (card, launches, time.perf_counter() - t_phase))
    return launches


def grid_scales(flags: list) -> int:
    """The grid scales a command's ``--use_grids`` turns on."""
    return flags[flags.index("--use_grids") + 1].split(",").count("1")


def campaign_launches(stage: str, ran: list, work: str,
                      launches: dict) -> None:
    """Every train command launched K4 and K5 12 times a step and grid
    scale and its evals K1; the int8a decode K3 (T times a batch) and
    the f32 decode no kernel. Adds them to ``launches``."""
    meta = {}
    if os.path.exists(os.path.join(work, "meta.json")):
        with open(os.path.join(work, "meta.json")) as f:
            meta = json.load(f)
    want_modules = {"data": [], "artifact": [],
                    "train": ["multiverse_torch.cli.train"],
                    # the killed process appends nothing
                    "resume": ["multiverse_torch.cli.train"],
                    "infer": ["multiverse_torch.cli.multifuture_inference",
                              "multiverse_torch.cli.multifuture_eval_trajs",
                              "multiverse_torch.cli."
                              "multifuture_eval_trajs_prob"] * 2}[stage]
    if [line["module"] for line in ran] != want_modules:
        raise AssertionError(f"campaign {stage}: commands {ran}")
    for line in ran:
        if line["module"] == "multiverse_torch.cli.train":
            # one class decode a grid scale, pred_len steps each
            want = line["steps"] * 12 * grid_scales(
                camp_flagship.FLAGSHIP_MODEL)
            if not line["steps"] or line["K4"] != want \
                    or line["K5"] != want or not line["K1"]:
                raise AssertionError(f"campaign {stage}: launches {line}")
        if line["module"] == "multiverse_torch.cli.multifuture_inference":
            decodes = [x for x in ran if x["module"] == line["module"]]
            # T: the longest ground-truth future of the test obs
            gt_dir = os.path.join(meta["mf_out"], "test")
            T = 0
            for name in os.listdir(gt_dir):
                with open(os.path.join(gt_dir, name), "rb") as f:
                    T = max([T] + [len(fut["x_agent_traj"])
                                   for fut in pickle.load(f).values()])
            batches = -(-meta["n_mf_obs"] // 16)
            want_k3 = 0 if line is decodes[0] else batches * T
            if line["K3"] != want_k3 or line["K1"] or line["K2"] \
                    or line["K7"]:
                raise AssertionError(f"campaign {stage}: decode {line}")
        for k in launches:
            launches[k] += line[k]


def campaign_checks(curve: dict, work: str, card: str) -> None:
    """The flagship artifact: the final val ADE below the first eval's,
    run B's saves above its kill step, every score finite."""
    conv, res = curve["convergence"], curve["resume_check"]
    run_b = curve["run_B_resume"]
    print("campaign phase (%s): flagship convergence %s" % (
        card, json.dumps(conv)))
    print("campaign phase (%s): flagship resume %s; killed at step %d, "
          "run B's evals at %s" % (card, json.dumps(res),
                                   run_b["killed_at_step"],
                                   [c["step"] for c in run_b["curve"]]))
    if not conv["final_eval"] < conv["first_eval"]:
        raise AssertionError(f"the flagship campaign did not learn: {conv}")
    killed = run_b["killed_at_step"]
    steps_b = [c["step"] for c in run_b["curve"]]
    saved = camp_flagship.saved_steps(os.path.join(work, "runs", "campB", "00", "save"))
    if steps_b[0] != killed or run_b["curve"][0]["loss_ma"] is not None \
            or not all(s > killed for s in steps_b[1:]) \
            or len(steps_b) < 2 or not saved or saved[-1] <= killed:
        raise AssertionError(f"run B's resume: killed at {killed}, evals "
                             f"at {steps_b}, saves {saved}")
    for tier, res_t in curve["final_inference"].items():
        vals = [res_t["ours"][i] for i in (0, 2, 3, 5)] + res_t["nll"]
        print("campaign phase (%s): flagship decode %s: minADE/minFDE %s, "
              "NLL %s" % (card, tier, res_t["ours"], res_t["nll"]))
        if not np.isfinite(vals).all():
            raise AssertionError(f"campaign {tier} scores: {res_t}")
    if sorted(curve["final_inference"]) != ["f32", "serving"]:
        raise AssertionError(f"campaign tiers: {curve['final_inference']}")


def tier_agreement(work: str, dev, card: str) -> dict:
    """Beam ids of the int8a decode (bf16, K3) against the f32 one (the
    plain path) on run A's best checkpoint of a flagship campaign's work
    directory, every test obs at K = 20, with each tier's minADE and
    minFDE (all futures) from the campaign's scores where it has them
    (information: the tiers on trained weights)."""
    with open(os.path.join(work, "meta.json")) as f:
        meta = json.load(f)
    cfg = flagship_config(video_h=camp_flagship.CAM_H,
                          video_w=camp_flagship.CAM_W)
    tiers = {"f32": cfg.replace(compute_dtype="float32"),
             "int8a": cfg.replace(decode_quant="int8a")}
    inputs = inference.load_multifuture_inputs(
        os.path.join(meta["obs_out"], "traj_2.5fps", "test"),
        os.path.join(meta["mf_out"], "test"), meta["mf_scene"],
        meta["id2name"], cfg)
    model = load_checkpoint(os.path.join(work, "runs", "campA", "00",
                                         "best"),
                            Multiverse.init(cfg)).to(dev)
    T = int(inputs.pred_lengths.max())
    same, top = [], []
    for start in range(0, len(inputs.traj_ids), 16):
        idx = np.arange(start, min(start + 16, len(inputs.traj_ids)))
        batch = batch_to_device(inference.make_batch(inputs, idx, cfg), dev)
        with torch.inference_mode():
            ids = {t: inference.beam_forward(model, batch, c, T_pred=T)[0]
                   .ids.cpu().numpy() for t, c in tiers.items()}
        for n, length in enumerate(batch.pred_length.cpu().numpy()):
            a, b = (ids[t][n, :, :length] for t in tiers)
            same.append((a == b).ravel())
            top.append(bool((a[0] == b[0]).all()))
    out = {"obs": len(inputs.traj_ids), "beam_id_share": float(
        np.mean(np.concatenate(same))), "top_beam_share": float(np.mean(top))}
    infer = os.path.join(work, "infer.json")
    if os.path.exists(infer):
        with open(infer) as f:
            scores = json.load(f)
        out.update({t: {"minADE_all": s["ours"][2], "minFDE_all": s["ours"][5]}
                    for t, s in scores.items()})
    print("campaign phase (%s): int8a against f32 on run A's best: %s"
          % (card, json.dumps(out)))
    return out


def main() -> int:
    if sys.argv[1:2] == ["--counted"]:
        return counted_command(sys.argv[2], sys.argv[3], sys.argv[4:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--wmma-shares"]:
        wmma_shares(sys.argv[2])
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    start = time.perf_counter()

    def elapsed(what: str) -> None:
        print("chip_smoke: %s done, %.1f s since the start"
              % (what, time.perf_counter() - start))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    _build.load_library()
    print("kernel build + load: %.1f s (%s)"
          % (time.perf_counter() - t0, _build.library_path().name))
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or "Performance Loss" in line:
            print("  ptxas:", line.strip())

    if sys.argv[1:2] == ["--recorded-only"]:
        with tempfile.TemporaryDirectory() as tmp:
            recorded_moment_phase(dev, tmp, smi.stdout.strip())
        return 0
    if sys.argv[1:2] == ["--tier-agreement"]:
        tier_agreement(sys.argv[2], dev, smi.stdout.strip())
        return 0
    if sys.argv[1:2] == ["--campaign-only"]:
        with tempfile.TemporaryDirectory() as tmp:
            campaign_phase(dev, tmp, smi.stdout.strip())
        return 0
    cfg = flagship_config()
    model = Multiverse.init(cfg, seed=0, device=dev)
    if sys.argv[1:2] == ["--gnn-only"]:
        gnn_kernel_phase(model, cfg, dev)
        return 0
    stats = kernel_phase(model, cfg, dev)

    inputs = inference.synthesize_multifuture_inputs(cfg, 32, seed=0)
    first16 = inputs._replace(
        traj_ids=inputs.traj_ids[:16],
        obs_traj=inputs.obs_traj[:16],
        obs_grid_class=inputs.obs_grid_class[:16],
        obs_grid_target=[t[:16] for t in inputs.obs_grid_target],
        obs_scene=inputs.obs_scene[:16],
        pred_lengths=inputs.pred_lengths[:16])
    stats.update(gnn_kernel_phase(model, cfg, dev))
    # phase 7's kernel part runs here, beside phase 5: torch.profiler's
    # per-launch reads come back empty after a step has been profiled
    # without acc_events (the train phase's)
    simaug_gnn_shapes(model, cfg, dev)
    elapsed("kernel phases")

    # the paths: each resets its kernels' counts before it runs and reads
    # them after; the pathless kernels' counts span all of them
    for fn in PATHLESS.values():
        fn.launches = 0
    launches = {"K1": offline_run(model, cfg, inputs, dev, "none")}
    id_agreement(model, cfg, inputs, dev)
    launches["K2"] = offline_run(model, cfg, first16, dev, "int8")
    launches["K3"] = offline_run(model, cfg, first16, dev, "int8a")
    launches["K7"] = offline_run(model, cfg, first16, dev, "int8_dyn")
    # the greedy decode gives K7 one row per trajectory, identity parents
    check_q8dyn_rows(model, cfg, dev, len(first16.traj_ids), True,
                     "offline greedy")
    launches["K7"] += offline_run(model, cfg, first16, dev, "int8_dyn",
                                  greedy=True)
    id_agreement(model, cfg, first16, dev, "int8_dyn", other="int8")
    launches["K3"] += serve_phase(QUICKSTART_FLAGS, dev, greedy=False,
                                  n_requests=32)
    launches["K3"] += serve_phase(QUICKSTART_FLAGS, dev, greedy=True,
                                  n_requests=64)
    launches["K7"] += serve_phase(
        QUICKSTART_FLAGS + ["--compute_dtype", "bfloat16", "--decode_quant",
                            "int8_dyn"], dev, greedy=False, n_requests=32,
        tier="int8_dyn", servers=SERVERS[:1])
    elapsed("offline and serve phases")
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_phase(dev, tmp)
        launches["K1"] += trained["K1"]
        launches["K4"], launches["K5"] = trained["K4"], trained["K5"]
        elapsed("preprocess and train phases")
        for k, n in lifecycle_phase(dev, tmp).items():
            launches[k] += n
        elapsed("serve-lifecycle phase")
        for k, n in multi_device_phase(dev, tmp,
                                       trained["throughput"]).items():
            launches[k] += n
        elapsed("multi-device phase")
        for k, n in tensor_parallel_phase(dev, tmp,
                                          smi.stdout.strip()).items():
            launches[k] += n
        elapsed("tensor-parallel phase")
        for k, n in data_prep_phase(dev, tmp, smi.stdout.strip()).items():
            launches[k] += n
        elapsed("data-prep phase")
        for k, n in plotting_phase(tmp, smi.stdout.strip()).items():
            launches[k] += n
        elapsed("plotting phase")
    simaug_run = simaug_phase(model, dev)
    for k in ("K1", "K4", "K5"):
        launches[k] += simaug_run[k]
    elapsed("simaug phase")
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in jax_checkpoint_phase(dev, tmp, smi.stdout.strip()).items():
            launches[k] += n
    elapsed("jax-checkpoint phase")
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in checkpoint_writing_phase(dev, tmp,
                                             smi.stdout.strip()).items():
            launches[k] += n
    elapsed("checkpoint-writing phase")
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in recorded_moment_phase(dev, tmp,
                                          smi.stdout.strip()).items():
            launches[k] += n
    elapsed("recorded-moment phase")
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in campaign_phase(dev, tmp, smi.stdout.strip()).items():
            launches[k] += n
    elapsed("campaign phase")
    for k, fn in PATHLESS.items():
        launches[k] = fn.launches
    print("main path launches of K6, K8, K9 (no path of the port or of the "
          "JAX package runs them): %s" % {k: launches[k] for k in PATHLESS})
    ran_not = [k for k in KERNELS if k not in PATHLESS and not launches[k]]
    if ran_not:
        raise AssertionError(f"kernels of the path never launched: {ran_not}")

    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k], **stats[k])
        for k in sorted(KERNELS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
