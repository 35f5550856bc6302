#!/usr/bin/env python3
"""Drive the vct_torch serving and training paths on one NVIDIA GPU and hold
their kernels against their plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and only a full pass prints the last
line):

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds the kernels of ``vct_torch/csrc`` (timed) and each
   kernel's registers, stack frame and spills are printed;
3. K1 ``pair_scores`` against ``pair_scores_ref`` on the card, SAD and
   flow both bit-equal (both sum exactly in integers and round once), each
   launch just after NaN was left in every SM's shared memory, each shape
   printed with its plan (``plan``: transitions a chunk, bands, cluster,
   threads, stages, blocks): the bench step, both served buckets, one
   decoded 320x240 video, L=2, the kernel-audit geometries, frames off a
   multiple of 16 bytes and an unaligned view (the byte path), a frame of
   one 16-byte word, one decoded 1080p video (more bands than a cluster),
   forced plans whose chunks and bands do not divide the clip on both
   paths, a served bucket in 20 bands, and all-equal frames, which must
   score exactly 0; then three CUDA-graph replays of a served bucket;
4. K4 ``ssim_pair_scores`` against ``ssim_pair_scores_ref`` on the card,
   each launch just after NaN was left in every SM's shared memory, each
   shape printed with its plan (``plan``: transitions a chunk, output rows
   a band, threads, blocks): atol 2e-6 (vct's tolerance) and bit-equal in
   every case (the window sums are exact, the f32 operations unfused and in
   the same order up to exact scalings by two, the mean summed in f64), at
   the bench shape, both served buckets, L=2, the kernel-audit geometries,
   the smallest 3x3 frame, H=3, L-1 and H-2 prime, row lengths 132, 258
   and 5 and an unaligned view (the byte path), a row of 384 bytes (two
   column groups), rows at decoded widths (320, 3840 and, on the byte
   path, 426 pixels: 4, 45 and 5 column groups), forced plans whose chunks
   and bands do not divide the clip, and all-equal frames, which must score
   exactly 1.0; then three CUDA-graph replays of a served bucket, each
   bit-equal;
5. K6 ``normalize_frames`` against ``normalize_frames_ref``: bit-exact, for
   the identity and an ImageNet mean/std, at (32, 60, 80, 80, 3), an odd
   element count, an unaligned view and C=1;
6. K3 ``selective_scan`` against ``selective_scan_ref`` on the card:
   atol = rtol = 1e-5 (f32: h is rounded as the plain version rounds it, y's
   sum over N runs in another order), both directions, each launch just
   after NaN was left in every SM's shared memory, each shape printed with
   its plan (``plan``: states a lane, lanes and warps a channel, state
   tiles, block threads, chunk steps): the deployed shapes (B=32 and a served B=4), VideoMamba's width
   (D=2048, N=16, L=256), the sweep's top N=64 at D=32, N = 1, 8, 12, 24,
   33, 64, 100 at the deployed widths, L=1, and the VideoMamba model's
   (B = 32 and 4, L=16, D=2048, N=16);
7. K2 ``lstm_stack`` / ``gru_stack`` and K5 ``lstm_scan`` / ``gru_scan``
   against their plain versions on the card, TF32 off, atol = rtol = 1e-5,
   each launched just after NaN was left in every SM's shared memory (a
   kernel that reads shared memory it did not write fails), and
   each shape printed with the kernel design it took (``design``, checked:
   "registers" for H <= 64, "clusters" up to H = 256, "columns" above) and
   a "clusters" shape with its plan (``plan``: CTAs and rows a cluster,
   clusters, how many the card holds at once): the bench stack (B=32, T=40,
   H=56, L=4), a served request (B=4), one video (B=1), the register
   design's edges (H=64 at L=4, the default width H=32 at T=60, T=130 over
   three staged chunks, H=16 with two k-slices), "clusters" at H=65, 96,
   97 (B=5: rows left over in the last cluster), 128 at the bench batch,
   256 at B=2 and B=33 and 128 at T=150 (staged chunks), "columns" at
   H=512, T=128 (the previous layer's outputs through L2 too), an odd H=5,
   T=1, and K5 forward and through the time flip; then the backward kernels (K3's
   ``selective_scan_bwd.cu``, K2/K5's ``lstm_bwd.cu``) against autograd
   through the plain versions, each gradient within 1e-5 of its largest
   magnitude, each launch after the NaN fill: K3 at the deployed step and
   L = 130 (three chunks) both directions, VideoMamba's width and N = 1, 24,
   64, 100, 300 (two state tiles), the VideoMamba model's (B = 32 and 4,
   L=16, D=2048, N=16), each shape printed with its plan
   (``bwd_plan``); the LSTM and GRU
   stacks, each shape printed with its backward design (checked as the
   forward's) and a "clusters" shape with its plan, at the bench stack, a
   request, the default width, H = 1, 5, 17, 64 (the register design's
   widest), T=130 over three chunks, "clusters" at H = 65, 97, 128 (B=32,
   and T=130), 256, and "columns" at H = 272; K5 at the bench shape
   both directions; two runs and a CUDA-graph replay bit-equal; and every
   register-design instance of the backward must report 0 spill bytes in
   the build's ptxas log;
8. the Mamba path — the deployed config (resnet50 bf16 backbone, 3 Mamba
   blocks, rnn_input 8, T=60, 80x80, scan_impl "pallas") with seeded
   weights serves three requests of four decoded videos each through
   ``sample_decoded_clips`` and ``classify_and_display``, with the kernels'
   launch counts read around exactly that run; then a bench-shaped batch
   (B=32, L=120, ragged lengths) is timed as clips/s, the kernel path is
   held against the same path with the plain versions substituted (equal
   frame indices, logits atol = rtol = 1e-4, TF32 off), and an f32 copy
   of the model on the card is held against the same model on the CPU
   (logits atol = rtol = 1e-3);
9. the SSIM path — the same deployed model serves three requests of four
   decoded videos with ``ssim`` (one request names ``ssim_most_unique``)
   selection, launch counts read around exactly that run (K4 once per video
   longer than T, K1 never, K3 three times per request), and its
   bench-shaped step is timed and held the same way under the label
   ``deployed_mamba_ssim``;
10. the LSTM/GRU path — the UCF50 geometry (resnet50 bf16, rnn_input 512,
   H=56, 4 layers, T=40, 80x80, scan_impl "pallas") serves one request of
   four videos for each of four heads (LSTM and GRU, uni- and
   bidirectional), with the launch counts read around each: one K2 launch
   per unidirectional forward, 2 x 4 K5 launches per bidirectional one;
   for the LSTM uni head a bench-shaped batch (B=32, L=80, ragged lengths)
   is timed as clips/s, held against the plain path (equal frame indices,
   logits atol = rtol = 1e-4) and against the CPU in f32 (1e-3);
11. the training path — for the deployed Mamba and the UCF50 LSTM at full
    width, ``python -m vct_torch.train``'s ``main`` on 40 synthetic clips
    (32 train, 8 test; B=32; 2 epochs), its epoch lines and metric block
    checked by ``extract_metrics`` and the forward and backward kernels'
    launches read around it; from the same weights, 5 Adam steps of the head
    on the same backbone features through the kernels and through the plain
    versions, dropout 0 and TF32 off, losses within 1e-4 relative and
    parameters too (in norm, over the elements whose gradient stayed above
    1e-5 of its tensor's largest; the rest within Adam's 2 lr a step), every
    trained parameter's kernel-path gradient present and within 1e-5 of the
    plain path's; the steady-state train step timed by events as
    ``train_clips_per_s`` with its launches a step, the backbone's forward and
    the head's step alone, and a ``torch.profiler`` breakdown of a step's
    device time by kernel; one train step each of the GRU and bidirectional
    UCF50 heads, launches checked;
12. resume, observability, warm start and weight import — for both
    configurations at full width, ``python -m vct_torch.train``'s main with
    dropout 0.25 and the plateau decay on (``RESUME_ARGS``: a learning rate of
    1e-11 moves the val loss by far less than the plateau's 1e-6, so the
    learning rate is lowered at epochs 2 and 3 by construction): 3 epochs
    uninterrupted, then with ``train.resume`` crashed after epoch 1 and after
    epoch 2 and resumed to 3, the last part with ``train.history_path``,
    ``train.log_every 1`` and ``train.profile_dir``; the final parameters and
    the three epoch losses must be bit-equal to the uninterrupted run's, each
    resumed epoch must launch the kernels as often as the same uninterrupted
    epoch (counters read around each epoch's train loop), the history must
    hold three epochs and the step times, one step line a step, and the
    trace's K3 or K2 forward and backward kernels must number what the
    counters counted in the traced epoch; ``save_train_state``'s time and
    file size are printed; a fourth Trainer with ``train.init_from`` the
    resumed checkpoint must start bit-equal to it. Then a seeded torchvision
    resnet50 state_dict (key list written out here) goes through
    ``model.backbone_weights`` into the deployed model, each tensor checked
    by an independent name map; a seeded reference-LRCN state_dict of the
    deployed config through ``vct_torch.tools.port_reference`` on the card
    and on the CPU; ``load_model`` on both; one 4-video SAD request served on
    the card through ``classify_and_display`` (K1 and K3 launches checked),
    its frames the CPU's (pixels within 1e-6: the card's /255 multiplies by
    the reciprocal) and its logits within 1e-4 (atol = rtol, TF32 off),
    labels equal;
13. the model zoo — VideoMamba at ``vct``'s full width (resnet50 in bf16,
    4 blocks, d_model 512, d_inner 2048, n_state 16, dt_rank 16, temporal
    mean, T=16, 80x80, scan_impl "pallas") serves three requests of four
    decoded videos with SAD selection (launches read around exactly that
    run: K1 once a video longer than T, K3 4 a forward, nothing else), its
    bench-shaped step (B=32, raw L=32, ragged) is timed as
    ``videomamba_clips_per_s`` and held as phase 8 holds the deployed one
    (kernel vs plain path, card vs CPU); ``python -m vct_torch.train``'s
    ``main`` trains it (40 synthetic clips, 2 epochs, K3 forward and
    backward launches counted), 5 Adam steps are held kernel vs plain as
    in phase 11 and its train step timed (``videomamba_train_step_ms``);
    the deployed LRCN on each other backbone (mobilenet_v2, the sweep
    winner's, then efficientnet_b0, densenet121, vgg16, alexnet,
    inception_v3) serves one request (K1, K3 counted) and its bench-shaped
    step is timed and held the same way (``lrcn_<backbone>_clips_per_s``);
    ``lrcn2`` and ``td_cnn_lstm`` serve one request each (K1 only: their
    recurrences are the plain loops, as in ``vct``); a seeded
    torchvision-layout mobilenet_v2 state_dict (key list written out here)
    goes through ``model.backbone_weights``, each tensor checked by an
    independent name map, and a seeded reference VideoMamba state_dict
    through ``vct_torch.tools.port_reference --model_family videomamba`` on
    the card and on the CPU, ``load_model`` on both, one request served on
    the card (launches counted), frames the CPU's and logits within 1e-4;
    one summary line gives the clips/s and the train step;
14. captioning — the five captioners of ``vct``'s ``CaptionConfig`` at full
    width (S2VT v2, 1s2vt, the transformer, the v1 LSTM and GRU; resnet50 in
    f32, width 512, 30 frames of 224x224, captions of 30 tokens, a seeded
    stand-in vocabulary of 10,000 words, seeded weights) each caption 8
    clips by beam search (K=3) and greedily, with every kernel's launch
    counter read around the run and required to be 0 (no kernel is on this
    path, in ``vct`` or in the port); each is held on the first 2 clips
    (``CAPTION_CPU_CLIPS``: all 8 cost the CPU 145 s) against an f32 copy on
    the CPU, TF32 off: teacher-forced log-probs within 1e-4, beam and greedy
    tokens equal except where the CPU scores the two sequences within 1e-4
    of each other (both printed), beam scores within 1e-4; beam captioning
    is timed as ``caption_<kind>_clips_per_s`` beside the backbone alone
    (``backbone_ms``; ``decode_ms`` the rest). ``python -m vct_torch.caption
    --synthetic`` runs 2 epochs for S2VT and the transformer (its 'Average
    BLEU score:' line checked); the S2VT train step at the CLI's batch
    (B=4, 30x224x224) is timed with and without the feature cache
    (``caption_train_step_ms``); 5 Adam steps on the card's backbone
    features are held card against CPU (dropout 0, 1e-4); a run resumed
    after epoch 1 must be bit-equal to the uninterrupted one; a seeded
    reference S2VT state_dict goes through ``port_reference_s2vt`` on the
    card and on the CPU, log-probs within 1e-4; launches 0 throughout;
15. files — video files in, labels out, for the deployed LRCN at full width
    (resnet50 in bf16, 3 Mamba blocks, T=60, 80x80, scan_impl "pallas"): a
    line of what the host decodes with (cv2, h5py, the ffmpeg libraries and
    headers, the native decoder); 64 seeded videos of 120 frames in 2 class
    directories and 8 served ones, written as uncompressed BGR24 AVI files
    (``_write_avi``), decoded back bit-equal to the seeded frames (the decode
    line says which decoder ran, or that none could and seeded frames
    stand in) and ingested by ``build_clipcache`` (host SAD to T), the
    cache held equal to the seeded clips sampled in process;
    ``python -m vct_torch.train --data.stream true --data.cache_format
    clipcache`` for one epoch at B=32 (K3 forward and backward launches
    counted), its loss and weights bit-equal to an in-memory ``fit`` on the
    same uint8 clips, then the streamed and in-memory fits timed in turns
    (``streamed_train_clips_per_s``, ``memory_train_clips_per_s``) with the
    host seconds a step spent waiting on the cache (``loader_s_per_step``);
    ``python -m vct_torch.serve.deployment`` on the served files with the
    trained checkpoint, ``--device_sampling`` sad and ssim, host sad, and
    ``--post`` to a local server: launches counted around each run (K1 or
    K4 once a video longer than T, K3 3), probabilities within 1e-5 of
    ``classify_videos`` in process, seconds a video end to end beside
    ``classify_videos`` alone;
16. the worker — phase 15's checkpoint and served files behind TikTok URLs,
    served through the port's stack: ``vct_torch.serve.backend`` on an
    ephemeral port with a ``ResultStore``, the queue, and a
    ``vct_torch.serve.worker.Worker`` on the card (host SAD sampling, a
    downloader that copies the URL's file, ``_local_downloader``); three
    files wait in VIDEO_DIR, so the first message classifies four videos
    and three URLs come from the store; a client asks ``GET /get_labels``
    for each of the 8 URLs. Launches are read around each message (K3 3 a
    forward, ceil(N/32) forwards; K1, K4 and the rest never); the stored
    scores within 1e-5 of ``classify_videos`` in process on clips sampled
    apart from the worker, the client's labels the stored ones, one row a
    URL, VIDEO_DIR empty. Seconds a URL end to end, a message's download,
    check, decode+select, forward and POST, beside ``classify_videos`` alone;
    then the peak device memory of ``classify_videos`` over 32 and 128 host
    clips of 60x80x80x3 (its rise under one chunk's f32 bytes);
17. caption files — captioning from video files at ``vct``'s full
    ``CaptionConfig`` (S2VT v2, resnet50 in f32, width 512, 30 frames of
    224x224, beam 3) and the CLI's B=4: 12 seeded videos of 60-150 frames at
    320x240 written as AVI files (``_write_avi``), two corrupt files beside
    them, an annotation file of two captions a file drawn from phase 14's
    stand-in vocabulary; ``extract_frames_interval`` held to the seeded
    frames it must choose (cv2's BGR order, the interval from the frame
    count, last-frame padding; decode ms a video); ``python -m
    vct_torch.caption --video_dir --annotations --epochs 2 --eval`` (its
    ``Epoch [`` and ``Average BLEU score:`` lines, the corrupt files skipped
    with a print, a checkpoint written); one epoch on the readable clips
    through ``LazyCaptionLoader`` (uint8, /255 on the device, the host
    seconds a step waits on decode) held bit-equal to ``fit`` on
    ``load_caption_dataset``'s clips in memory (/255 on the host), timed as
    clips/s beside it; ``--caption_videos DIR --model CKPT``: one
    ``Generated Caption:`` line a readable video, equal to ``caption_videos``
    in process on clips decoded apart, seconds a video beside
    ``caption_videos`` alone; a ``vct`` caption artifact as ``--model``
    refused naming the converter; every launch counter 0 around the phase;
18. the AOT servable — one-file ``torch.export`` artifacts
    (``vct_torch.serve.aot``): phase 15's checkpoint exported through
    ``python -m vct_torch.serve.aot`` dense (``--batches 1,32``) and raw
    (``--device_sampling sad --raw_len 120``); seeded models exported in
    process, one bucket of 32 each: the deployed configuration with
    ``ssim`` sampling (K4), the UCF50 LSTM (K2) and a bidirectional UCF50
    GRU (K5); phase 17's caption checkpoint through the CLI (``--batches
    1,4``). Each artifact held to the eager path on the same clips in the
    same chunks (``classify_videos``, ``device_sample_clips`` and the model,
    ``beam_search``): probabilities and scores within 1e-5, tokens equal;
    the launches read around each artifact call (K1 or K4 one a raw chunk,
    K3 three a forward, K2 one, K5 two a layer; a classifier artifact whose
    counters stay at 0 fails; the caption artifact launches none); export,
    MB, load and warmup seconds, B=1 latency and B=32 clips/s beside the
    eager path's, in turns. Then the deployment CLI with the dense artifact
    over phase 15's served files (the checkpoint's labels, scores within
    1e-5), phase 16's worker flow over 3 URLs with MODEL_PATH the artifact
    (scores within 1e-5 of the checkpoint's forward at the artifact's batch
    size, B=1, K3's launches counted; the distance to the checkpoint's
    worker, which pads to B=32, printed), ``--caption_videos`` with the
    caption artifact (the checkpoint's captions), and a fresh interpreter
    that loads and serves the dense artifact on the card without importing
    the model zoo, the config, the host preprocessing or the trainer
    (``AOT_NO_ZOO``); the phase's seconds;
19. sweeps — (a) ``python -m vct_torch.sweep``'s ``main`` in process with
    ``--strategy grid`` over ``model.rnn_type`` in {mamba, lstm, gru} at the
    deployed configuration's full width (resnet50 in bf16, rnn_input 8, 3
    layers, T=60, 80x80, scan_impl "pallas", the feature cache; 40 synthetic
    clips, B=32, 2 epochs, one run a configuration, every trial recorded):
    three trials launching K3, K2-LSTM and K2-GRU, each trial's forward and
    backward launches read around it and held to its steps
    (``_expected_train_launches``), its seconds, F1 and accuracy (printed, not
    gated: this head's training is chaotic) and ``memory_allocated`` after
    it printed; then the same argv again, which must skip every
    configuration, launch nothing and leave the store byte-equal. (b) Each
    trial's best-model directory loads through ``load_model`` and classifies
    4 seeded clips within 1e-5 of the trial's own trained model (read at the
    end of the trial; those launches not counted as the trial's). (c) One
    trial in the subprocess mode: a ``python -m vct_torch.train`` child on
    the card, the scraped metrics equal to what the child printed, its output
    in ``sweep.log_file``. (d) ``vct_torch.tools.sweep_rehearsal``'s TPE sweep
    in process with 8 trials of 3 epochs, its trial journal and the
    compaction into the canonical JSON checked; then the genetic algorithm on
    the same data (population 4), stopped after one generation and resumed
    from its checkpoint to two; one trial streamed from the rehearsal's clip
    cache (``data.stream``). Every trial runs under ``_sweep_guard``: a
    trial that raises fails the phase (the runner alone would log it and go
    on), one whose head kernels never launched fails it, and so does device
    memory that grows past the first trial's level plus 64 MB; the phase's
    seconds;
20. mesh (``_mesh_path``) — training and serving across ranks and replicas
    (``vct_torch.parallel``) at the deployed configuration (resnet50 in
    bf16, 3 Mamba blocks, T=60, 80x80, B=32 seeded uint8 clips, dropout
    0.25), 3 train steps under the deployed Adam (lr 1e-4) and, beside it,
    SGD at lr 1e-3 (``MESH_OPTIMIZERS``): (a) a world of one rank over NCCL
    (one NCCL all-reduce checked) against the plain ``Trainer`` on the same
    card, in turns: losses and every parameter within 1e-6, K3's launches
    equal (9 forward, 9 backward), the step ms of both; (b) two ranks
    sharing the card over gloo (``python3 chip_smoke.py --mesh-rank ROOT``,
    started by ``vct_torch.tools.dryrun.run_world``) at (data 2, model 1)
    and (data 1, model 2): the first loss and every parameter after the 3
    steps within 1e-5 of (a)'s under SGD; under Adam every parameter after
    the first step within 1e-5, except the elements whose gradient in (a)
    lies below 1e-4 of its tensor's largest, within 2 lr, and after the
    third within 2 lr a step, the share beyond 1e-5 printed; the
    parameters' largest change printed beside the limit; K3 9 / 9 on each
    rank;
    (c) phase 15's checkpoint served by two replicas on cuda:0 on raw SAD
    clips (K1, K3) through ``classify_videos`` and a ``data_parallel=2``
    artifact, within 1e-5 of the one-device path at a replica's rows a
    forward, K1 and K3 counted a replica; (d) the multichip dryrun over NCCL
    when ``torch.cuda.device_count() > 1``, else a line saying it was not
    run; the phase's seconds;
21. finetune and fold (``_finetune_path``) — the deployed configuration at
    full width (resnet50 in bf16, 3 Mamba blocks, T=60, 80x80, B=32 seeded
    uint8 clips, dropout 0.25, Adam at lr 1e-4): (a) raw uint8 clips, cast
    to the compute dtype, into a model whose stem conv holds the 1/255
    (``fold_input_scale_into_stem``) against x / 255 into the plain one on
    the same clips, the logits' largest difference within 1e-1 in bf16 and
    1e-4 in f32 (TF32 off), both bf16 forwards timed in turns; (b) 3 frozen
    train steps and 3 ``model.finetune`` steps with ``model.remat_backbone``
    off and on, in turns, under cudnn's deterministic algorithms: each
    step's ms, peak ``max_memory_allocated`` and its rise above the step's
    start; the two finetune runs' losses bit-equal, every parameter within
    1e-5 of its tensor's largest change, the backbone called once a step
    without remat and twice with it (a forward pre-hook), K3 9 forward and
    9 backward in each of the three runs; (c) two steps with
    ``model.freeze_until`` conv1 to layer3: after each, only layer4's
    backbone parameters have moved; each step's ms (the first a new
    trainer's); the phase's seconds;
22. the LSTM/GRU path at H = 128 (``_h128_path``) — the UCF50 LSTM
    configuration (resnet50 in bf16, 4 layers, T=40, 80x80, scan_impl
    "pallas") with rnn_input_size 32 and hidden_size unset, so H = 4 * 32
    = 128 by ``resolved_hidden_size``, and its GRU and bidirectional-GRU
    variants (dropout 0, TF32 off): each head's designs ("clusters" forward
    and backward, checked) and plans printed; one request of four decoded
    videos through ``classify_videos``, K2 (one launch) or K5 (2 x 4) read
    around exactly that call, and the clips' logits through the kernels
    within 1e-4 of the plain path's; three train steps at B=32 on the
    backbone's features, before each every trained parameter's kernel-path
    gradient within BWD_RTOL of its largest on the plain path from the same
    parameters, each step's forward and backward launches read around it;
    the phase's seconds;
23. timing — one JSON line ``{"kernels": [...]}`` with each kernel's
    launches, error, time, plain time, bound (K3 forward and backward also at
    the VideoMamba step, B=32 T=16 D=2048 N=16, ``"config": "videomamba"``,
    launches from phase 13) and, for K2/K5, the design,
    ``us_per_step`` (device time over T*L) and cuDNN's ``nn.LSTM`` /
    ``nn.GRU`` time (``library_ms`` by events; ``library_device_ms`` replayed
    from a CUDA graph or, where capture fails (cuDNN's LSTM backward at
    T = 130), the time its kernels keep the card busy under
    ``torch.profiler``, as ``library_device_via`` says), for K3 its plan, ``us_per_step``
    (device time over L), ``expf_bound_ms`` (one expf a state and step
    at the SFUs' rate) and ``launch_ms`` (the launch without the wrapper's
    checks, by events), and a line of extra timings at the other shapes,
    with the LSTM stack's backward at T = 130 beside cuDNN's
    (``lstm_stack_bwd_T130``) and above H = 64, at the two widths of the
    forward's "clusters" rows (``lstm_stack_bwd_H65_L4``,
    ``lstm_stack_bwd_H256_L2``, with cuDNN's backward), K3's backward at
    VideoMamba's shape
    (``selective_scan_bwd_videomamba``), K3's device time under S = 1 and 2, each
    with the plan's 128-thread blocks and 64-step chunks, 64- or 256-thread
    blocks, or 32-step chunks, at five shapes (``selective_scan_plans``), and K4's device time under
    its plan and, for each K, the two band heights whose block counts lie
    either side of two an SM, each checked bit-equal first, at the three
    main-path shapes and one decoded 320x240 video
    (``ssim_pair_scores_plans``); K1's time by events, its bare launch
    (``launch_ms``, without the wrapper's checks), its device time and its
    plan at the bench step (SAD and flow), both served buckets and one
    decoded 320x240 video, and its device time under the plan's choice and
    its neighbours, each checked bit-equal first, at the four SAD shapes
    (``pair_scores_plans``). K6 is on no serving path (as in vct): its
    launches are 0. ``_k4_timing`` and ``_k1_timing`` use only the public
    names of their kernels' modules (and K1's ``plan`` and ``_launch`` where
    they exist), so they can time an older checkout's kernels too: load this
    file by its path from that checkout's root, or, for K1, run
    ``python3 chip_smoke.py --k1-timing ROOT``, which prints only
    ``k1_timings`` of the package at ROOT. The backward rows (launches from
    the training path) carry the time of the whole backward entry point,
    autograd through the plain version as ``plain_ms``, and for LSTM/GRU
    cuDNN's backward alone as ``library_ms``, and both timed by the same
    profiler union as ``device_busy_ms`` and ``library_busy_ms`` (one method
    for both where cuDNN's capture fails); K3's its plan, ``us_per_step``
    and ``kernel_launches`` (device launches a call, ``torch.profiler``);
    ``python3 chip_smoke.py --step-timing ROOT`` prints only the existing
    configurations' serving and train steps (``step_timings``) of the
    package at ROOT, an older checkout's too, for a comparison of parent and
    change in one call; ``python3 chip_smoke.py --bwd-timing ROOT`` prints only the backward
    entry points' times (``bwd_timings``: K3's at the deployed step and
    VideoMamba's shape with its launches a call, K2/K5's, and K2's above
    H = 64 with cuDNN's backward beside it) for the package at ROOT, an
    older checkout's too; ``python3 chip_smoke.py --rnn-timing ROOT``
    prints only K2/K5 above H = 64 (``rnn_timings``, RNN_TIMING_ROWS: each
    row's forward and backward entry points, LSTM and GRU, and K5 at B=32
    T=40 H=128, beside cuDNN's, and, where the package has the "clusters"
    design, each row's plan and every plan's device time) for the package
    at ROOT, an older checkout's too.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core f32 rate, used for the integer and f32 ALU work here.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# expf's MUFU.EX2 on the special-function units: 16 a clock per SM (Hopper
# white paper), 132 SMs at the 1.98 GHz boost clock.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# K3 backward's least f32 work a (batch, step, channel, state): dh, its
# products with B, C, h_{t-1}, a, dt and u, and the carry (vct_torch/csrc/
# selective_scan_bwd.cu), beside one expf.
SCAN_BWD_FLOPS = 12

T, H, W = 60, 80, 80

# The deployed config (bench.py VCT_BENCH_MODEL=mamba), with the kernels' scan_impl.
DEPLOYED = dict(cnn_backbone="resnet50", rnn_type="mamba", rnn_input_size=8, rnn_layer=3,
                scan_impl="pallas")
# K4's least work in instructions, as counted in vct_torch/csrc/ssim.cu's
# note: per element of a frame (each frame's window sums formed once) and per
# valid (pair, element), plus one reciprocal per (pair, element).
SSIM_FRAME_INSTRUCTIONS = 11
SSIM_PAIR_INSTRUCTIONS = 17
# Instruction issue: 128 a clock per SM (four schedulers of 32 lanes), 132
# SMs at the 1.98 GHz boost clock of SFU_EXP_PER_S; MUFU.RCP on the 16-a-clock pipe.
ISSUE_PER_S = 128 * 132 * 1.98e9
SFU_RCP_PER_S = SFU_EXP_PER_S
# K4's plans are timed at the main-path shapes and one decoded 320x240 video.
SSIM_PLAN_SHAPES = [(32, 2 * T, H, W, 3), (1, 2 * T, H, W, 3), (1, 4 * T, H, W, 3),
                    (1, 2 * T, 240, 320, 3)]

# The UCF50 geometry bench.py times by default, with the kernels' scan_impl.
T_UCF50 = 40
UCF50 = dict(cnn_backbone="resnet50", rnn_input_size=512, hidden_size=56, rnn_layer=4,
             rnn_out="all", scan_impl="pallas")
# K2 / K5 entry points and the TPU kernels they replace.
RNN_KERNELS = {
    "lstm_stack": "vct/ops/lstm_pallas.py:354",
    "gru_stack": "vct/ops/lstm_pallas.py:355",
    "lstm_scan": "vct/ops/lstm_pallas.py:352",
    "gru_scan": "vct/ops/lstm_pallas.py:353",
}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` log: its
    mangled name, registers, and stack frame and spills."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            rows.append(f"  {name}: {line.split('Used', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return rows


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _ssim_bound_ms(B: int, L: int, H_: int, W_: int, C: int) -> tuple[float, str]:
    """K4's least time: the larger of its bytes over the memory rate, its
    instructions over the issue rate and its reciprocals over the MUFU rate.
    Every input byte read once and each f32 score written once; each frame's
    window sums formed once (SSIM_FRAME_INSTRUCTIONS per element of every
    frame), the rest per pair. Instructions are the unit counted, and the
    bound is named "operations" as the kernels line names every count."""
    frame_elems = (H_ - 2) * (W_ - 2) * C
    n_bytes = B * L * H_ * W_ * C + B * (L - 1) * 4
    n_instr = (SSIM_FRAME_INSTRUCTIONS * B * L + SSIM_PAIR_INSTRUCTIONS * B * (L - 1)) * frame_elems
    t_bytes, t_instr = n_bytes / HBM_BYTES_PER_S, n_instr / ISSUE_PER_S
    t_rcp = B * (L - 1) * frame_elems / SFU_RCP_PER_S
    return max(t_bytes, t_instr, t_rcp) * 1e3, ("bytes" if t_bytes >= max(t_instr, t_rcp)
                                                 else "operations")


def _events_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _events_ms(torch, graph.replay, 5, warmup=1) / iters


# K1 shapes the check and the timings share: the bench step, the two served
# buckets, and one decoded 320x240 video (scored before any resize).
K1_SHAPES = [(32, 2 * T, H, W, 3), (1, 2 * T, H, W, 3), (1, 4 * T, H, W, 3),
             (1, 2 * T, 240, 320, 3)]


def _k1_bound_ms(B: int, L: int, H_: int, W_: int, C: int) -> tuple[float, str]:
    """K1's least time: every frame read once and each f32 score written
    once, against three integer operations a byte of each pair."""
    F = H_ * W_ * C
    return _bound_ms(B * L * F + B * (L - 1) * 4, 3 * B * (L - 1) * F)


def _check_pair_scores(torch, gen):
    from vct_torch.ops import _build
    from vct_torch.ops.pair_scores import _launch, pair_scores, pair_scores_ref, plan

    shapes = K1_SHAPES + [
        (4, 2, H, W, 3),     # L = 2
        (2, 12, 16, 16, 3),  # the kernel-audit geometries: odd H, C=1,
        (1, 9, 11, 44, 3),   # L crossing a chunk boundary
        (2, 10, 8, 48, 3),
        (1, 7, 9, 86, 3),
        (2, 21, 16, 48, 1),
        (3, 13, 7, 5, 1),    # odd H*W*C: the byte path
        (1, 9, 5, 7, 3),     # 105 bytes a frame: the byte path
        (2, 9, 4, 4, 1),     # a frame of one 16-byte word: one band
        (1, 5, 1080, 1920, 3),  # one decoded 1080p video: more bands than a cluster
    ]
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda(), None)
             for s in shapes]
    flat = torch.randint(0, 256, (1 + 2 * 10 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 2x10x8x8x3", flat[1:].view(2, 10, 8, 8, 3), None))
    frame = torch.randint(0, 256, (1, 1, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    static = frame.expand(4, 30, H, W, 3).contiguous()
    cases.append(("all-equal 4x30x80x80x3", static, None))
    # Forced plans whose chunks and bands do not divide the clip, on the
    # vector path (162 words a frame) and the byte path (2280 bytes), and
    # bands beyond a cluster on one served bucket.
    for K, nb in ((1, 1), (3, 5), (7, 17)):
        for shape in ((1, 11, 18, 48, 3), (2, 24, 19, 40, 3)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
            cases.append((f"{shape} K={K} bands={nb}", x, plan(*shape, K, nb)))
    x = torch.randint(0, 256, (1, 2 * T, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    cases.append((f"(1, {2 * T}, {H}, {W}, 3) K=7 bands=20", x, plan(*x.shape, 7, 20)))
    for name, x, forced in cases:
        p = plan(*x.shape) if forced is None else forced
        for method in ("sad", "flow"):
            _build.fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
            got = (pair_scores(x, method) if forced is None
                   else _launch(x, forced, method == "flow"))
            want = pair_scores_ref(x, method)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pair_scores {method} {name}: not bit-equal, max abs err "
                                     f"{(got - want).abs().max().item()}")
            if x is static and bool(got.any()):
                raise AssertionError(f"pair_scores {method}: all-equal frames do not score 0")
        print(f"  K1 {name}: plan {p['design']} K={p['chunk_pairs']} bands={p['bands']} "
              f"cluster={p['cluster']} threads={p['threads']} "
              f"blocks={p['blocks']}")
    # Three replays of a CUDA graph of a served bucket.
    x = torch.randint(0, 256, (1, 2 * T, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair_scores(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = pair_scores(x)
    replays = []
    for _ in range(3):
        _build.fill_shared_memory(float("nan"))
        graph.replay()
        replays.append(y.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, pair_scores_ref(x)) for r in replays):
        raise AssertionError("pair_scores: CUDA graph replays differ from the plain version")
    print(f"K1 pair_scores: {len(cases)} shapes and plans x (sad, flow) bit-equal, each after a "
          f"NaN fill of shared memory; all-equal frames score 0; 3 graph replays bit-equal; "
          f"max abs err 0.0")
    return 0.0


def _k1_timing(torch, gen, B: int, L: int, H_: int = H, W_: int = W, method: str = "sad") -> dict:
    """K1 on (B, L, H_, W_, 3) random frames: its plan, time by events and
    from a CUDA graph, the bare launch (where the package has one), the
    plain version's time and the bound. Only the public names of
    ``vct_torch.ops.pair_scores`` besides, so an older package (one with no
    ``plan``) is timed the same way."""
    from vct_torch.ops import pair_scores as k1

    x = torch.randint(0, 256, (B, L, H_, W_, 3), dtype=torch.uint8, generator=gen).cuda()
    bound, by = _k1_bound_ms(B, L, H_, W_, 3)
    p = k1.plan(B, L, H_, W_, 3) if hasattr(k1, "plan") else None
    launch_ms = None
    if p is not None and hasattr(k1, "_launch"):
        launch_ms = _events_ms(torch, lambda: k1._launch(x, p, method == "flow"), 50)
    return {
        "shape": [B, L, H_, W_, 3], "method": method, "plan": p,
        "ms": _events_ms(torch, lambda: k1.pair_scores(x, method), 50),
        "launch_ms": launch_ms,
        "device_ms": _graph_ms(torch, lambda: k1.pair_scores(x, method), 20),
        "plain_ms": _events_ms(torch, lambda: k1.pair_scores_ref(x, method), 5),
        "bound_ms": bound, "bound_by": by,
    }


def _k1_neighbours(B: int, L: int, H_: int, W_: int, C: int) -> list[tuple[str, int, int]]:
    """(design, K, bands) of the plan's choice and its neighbours: the other
    design; in the "bands" design, half and twice the choice's K, the K of
    one chunk more and one fewer, the whole clip in one chunk, each with half
    and twice its bands."""
    from vct_torch.ops.pair_scores import plan

    p = plan(B, L, H_, W_, C)
    bands = p if p["design"] == "bands" else plan(B, L, H_, W_, C, design="bands")
    K, nb, pairs, chunks = bands["chunk_pairs"], bands["bands"], L - 1, bands["chunks"]
    ks = {K, max(1, K // 2), min(pairs, 2 * K), pairs, -(-pairs // (chunks + 1))}
    if chunks > 1:
        ks.add(-(-pairs // (chunks - 1)))
    out = [(p["design"], p["chunk_pairs"], p["bands"])]
    try:
        q = plan(B, L, H_, W_, C, design="chunks")
        out.append(("chunks", q["chunk_pairs"], q["bands"]))
    except ValueError:
        pass
    for k in sorted(ks):
        for b in sorted({nb, max(1, nb // 2), 2 * nb}):
            try:
                q = plan(B, L, H_, W_, C, k, b, "bands")
            except ValueError:
                continue
            if ("bands", q["chunk_pairs"], q["bands"]) not in out:
                out.append(("bands", q["chunk_pairs"], q["bands"]))
    return list(dict.fromkeys(out))


def _k1_plans(torch, gen, B: int, L: int, H_: int, W_: int, C: int) -> dict:
    """K1's device time under the plan's choice and its neighbours, each
    checked bit-equal to the plain version (SAD) first."""
    from vct_torch.ops.pair_scores import _launch, pair_scores_ref, plan

    x = torch.randint(0, 256, (B, L, H_, W_, C), dtype=torch.uint8, generator=gen).cuda()
    want = pair_scores_ref(x)
    times = {}
    for design, K, nb in _k1_neighbours(B, L, H_, W_, C):
        p = plan(B, L, H_, W_, C, K, nb, design)
        if not torch.equal(_launch(x, p, False), want):
            raise AssertionError(f"pair_scores: plan {design} K={K} bands={nb} not bit-equal")
        key = (f"{design}_K{K}_bands{nb}_cluster{p['cluster']}_blocks{p['blocks']}"
               f"_threads{p['threads']}")
        times[key] = _graph_ms(torch, lambda: _launch(x, p, False), 20)
    return {"shape": [B, L, H_, W_, C], "plan": plan(B, L, H_, W_, C), "device_ms": times}


def _k4_timing(torch, gen, B: int, L: int, H_: int = H, W_: int = W) -> dict:
    """K4 on (B, L, H_, W_, 3) random frames: its plan, time by events and
    from a CUDA graph, the plain version's time and the bound. Only the
    public names of ``vct_torch.ops.ssim``, so an older package (one with
    no ``plan``) is timed the same way."""
    from vct_torch.ops import ssim

    x = torch.randint(0, 256, (B, L, H_, W_, 3), dtype=torch.uint8, generator=gen).cuda()
    bound, by = _ssim_bound_ms(B, L, H_, W_, 3)
    return {
        "shape": [B, L, H_, W_, 3],
        "plan": ssim.plan(B, L, H_, W_, 3) if hasattr(ssim, "plan") else None,
        "ms": _events_ms(torch, lambda: ssim.ssim_pair_scores(x), 20),
        "device_ms": _graph_ms(torch, lambda: ssim.ssim_pair_scores(x), 20),
        "plain_ms": _events_ms(torch, lambda: ssim.ssim_pair_scores_ref(x), 3, warmup=1),
        "bound_ms": bound, "bound_by": by, "bound_counts": "instructions",
    }


def _k4_plans(torch, gen, B: int, L: int, H_: int, W_: int, C: int) -> dict:
    """K4's device time under the plan's choice and, for each K, the two
    band heights R whose block counts lie either side of RESIDENT_BLOCKS
    (two an SM; at the bench shape the whole frame and half of it), each
    checked bit-equal to the plain version first."""
    from vct_torch.ops.ssim import (MAX_CHUNK_PAIRS, RESIDENT_BLOCKS, _constants, _launch, plan,
                                    ssim_pair_scores_ref)

    x = torch.randint(0, 256, (B, L, H_, W_, C), dtype=torch.uint8, generator=gen).cuda()
    want, constants = ssim_pair_scores_ref(x), _constants(3, 255.0)
    chosen = plan(B, L, H_, W_, C)
    heights = sorted({-(-(H_ - 2) // n) for n in range(1, H_ - 1)}, reverse=True)
    plans = {(chosen["chunk_pairs"], chosen["band_rows"])}
    for K in range(1, MAX_CHUNK_PAIRS + 1):
        blocks = [(R, B * -(-(L - 1) // K) * -(-(H_ - 2) // R)) for R in heights]
        below = [R for R, n in blocks if n < RESIDENT_BLOCKS]
        above = [R for R, n in blocks if n >= RESIDENT_BLOCKS]
        plans.update((K, R) for R in below[-1:] + above[:1 if below else 2])
    times = {}
    for K, R in sorted(plans):
        p = plan(B, L, H_, W_, C, K, R)
        got = _launch(x, p, constants)
        if not torch.equal(got, want):
            raise AssertionError(f"ssim_pair_scores: plan K={K} R={R} not bit-equal")
        times[f"K{K}_R{R}_blocks{p['blocks']}"] = _graph_ms(torch, lambda: _launch(x, p, constants),
                                                            20)
    return {"shape": [B, L, H_, W_, C], "plan": chosen, "device_ms": times}


def _check_ssim(torch, gen):
    from vct_torch.ops import _build
    from vct_torch.ops.ssim import _constants, _launch, plan, ssim_pair_scores, ssim_pair_scores_ref

    shapes = [
        (32, 120, H, W, 3),  # bench-like batch (L = 2T)
        (1, 120, H, W, 3),   # one bucket-padded video, both buckets the
        (1, 240, H, W, 3),   # served requests below use
        (4, 2, H, W, 3),     # L = 2
        (2, 12, 16, 16, 3),  # the kernel-audit geometries: odd H, C=1,
        (1, 9, 11, 44, 3),   # L crossing a chunk boundary
        (2, 10, 8, 48, 3),
        (1, 7, 9, 86, 3),
        (2, 21, 16, 48, 1),
        (3, 5, 3, 3, 3),     # the smallest frame
        (3, 13, 7, 5, 1),    # odd H*W*C
        (1, 30, 3, 80, 3),   # one output row (H=3) in every band
        (2, 24, 19, 40, 3),  # L-1 and H-2 prime: uneven chunks and bands
        (2, 9, 12, 132, 1),  # row lengths off 16 bytes: the byte path
        (2, 9, 12, 258, 1),
        (2, 9, 12, 5, 1),
        (1, 6, 9, 128, 3),   # more columns than a block's threads
        (1, 9, 14, 320, 3),  # decoded widths, as served frames arrive: UCF50's
        (1, 4, 6, 3840, 3),  # 320, 4K's 3840 and (byte path) 240p's 426 pixels
        (1, 4, 6, 426, 3),
    ]
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda(), None)
             for s in shapes]
    flat = torch.randint(0, 256, (1 + 2 * 10 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 2x10x8x8x3", flat[1:].view(2, 10, 8, 8, 3), None))
    frame = torch.randint(0, 256, (1, 1, H, W, 3), dtype=torch.uint8, generator=gen).cuda()
    static = frame.expand(4, 30, H, W, 3).contiguous()
    cases.append(("all-equal 4x30x80x80x3", static, None))
    # Forced plans where chunks and bands do not divide the clip, on both paths.
    for K, R in ((1, 1), (3, 5), (7, 17)):
        for shape in ((2, 24, 19, 40, 3), (1, 11, 18, 43, 3)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
            cases.append((f"{shape} K={K} R={R}", x, plan(*shape, K, R)))
    err, equal = 0.0, 0
    for name, x, forced in cases:
        _build.fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
        got = ssim_pair_scores(x) if forced is None else _launch(x, forced, _constants(3, 255.0))
        want = ssim_pair_scores_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, msg=f"ssim_pair_scores {name}")
        err = max(err, (got - want).abs().max().item())
        equal += int(torch.equal(got, want))
        p = plan(*x.shape) if forced is None else forced
        print(f"  K4 {name}: plan K={p['chunk_pairs']} R={p['band_rows']} "
              f"threads={p['threads']} blocks={p['blocks']}")
    if equal != len(cases):
        raise AssertionError(f"ssim_pair_scores: bit-equal in {equal} of {len(cases)} only")
    _build.fill_shared_memory(float("nan"))
    if not torch.equal(ssim_pair_scores(static), torch.ones((4, 29), device=static.device)):
        raise AssertionError("ssim_pair_scores: all-equal frames do not score exactly 1.0")
    # A CUDA graph replays the launch with its (clip, chunk) counters as the
    # last replay left them: every replay must give the same scores.
    x = cases[1][1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssim_pair_scores(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ssim_pair_scores(x)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(y.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, ssim_pair_scores_ref(x)) for r in replays):
        raise AssertionError("ssim_pair_scores: CUDA graph replays differ from the plain version")
    print(f"K4 ssim_pair_scores: {len(cases)} shapes and plans agree within 2e-6, bit-equal in "
          f"{equal} of {len(cases)}, each after a NaN fill of shared memory; all-equal frames "
          f"score exactly 1.0; 3 graph replays bit-equal; max abs err {err}")
    return err


IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _check_normalize(torch, gen):
    from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref

    shapes = [(32, T, H, W, 3), (3, 7, 5, 3), (2, 5, 9, 1)]  # the bench clips, odd size, C=1
    cases = [(s, torch.randint(0, 256, s, dtype=torch.uint8, generator=gen).cuda()) for s in shapes]
    flat = torch.randint(0, 256, (1 + 4 * 8 * 8 * 3,), dtype=torch.uint8, generator=gen).cuda()
    cases.append(("unaligned 4x8x8x3", flat[1:].view(4, 8, 8, 3)))
    err = 0.0
    for name, x in cases:
        C = x.shape[-1]
        for mean, std in ((None, None), (IMAGENET_MEAN[:C], IMAGENET_STD[:C])):
            got, want = normalize_frames(x, mean, std), normalize_frames_ref(x, mean, std)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"normalize_frames {name} mean={mean}: not bit-exact, max abs "
                                     f"err {(got - want).abs().max().item()}")
            err = max(err, (got - want).abs().max().item())
    print(f"K6 normalize_frames: {len(cases)} shapes x (identity, ImageNet) bit-exact; "
          f"max abs err {err}")
    return err


def _scan_inputs(torch, gen, B, L, D, N):
    u = torch.randn(B, L, D, generator=gen)
    delta = torch.rand(B, L, D, generator=gen) * 0.5
    A = -torch.rand(D, N, generator=gen) - 0.1
    Bm = torch.randn(B, L, N, generator=gen)
    Cm = torch.randn(B, L, N, generator=gen)
    return [t.cuda() for t in (u, delta, A, Bm, Cm)]


# K3 shapes (B, L, D, N): the bench-shaped batch, a served request
# (batch_size 4), VideoMamba's width, the sweep's top (rnn_input_size 16:
# N = hidden = 64), every state size the LRCN's hidden_size can give it
# (N = 1 to 100, at the deployed widths of a request), L = 1, and the
# VideoMamba model's own (B=32 bench and train steps, B=4 requests; T=16).
SCAN_SHAPES = ([(32, T, 16, 32), (4, T, 16, 32), (2, 256, 2048, 16), (32, T, 32, 64)]
               + [(4, T, 16, n) for n in (1, 8, 12, 24, 33, 64, 100)] + [(4, 1, 16, 32)]
               + [(32, 16, 2048, 16), (4, 16, 2048, 16)])
# K3 shapes timed under other plans: the first four, and N=100 (four warps a channel).
SCAN_PLAN_SHAPES = SCAN_SHAPES[:4] + [(4, T, 16, 100)]


def _check_selective_scan(torch, gen):
    from vct_torch.ops._build import fill_shared_memory
    from vct_torch.ops.selective_scan import plan, selective_scan, selective_scan_ref

    err = 0.0
    for dims in SCAN_SHAPES:
        args = _scan_inputs(torch, gen, *dims)
        for reverse in (False, True):
            fill_shared_memory(float("nan"))  # a stale read of shared memory fails the check
            got = selective_scan(*args, reverse=reverse)
            want = selective_scan_ref(*args, reverse=reverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            err = max(err, (got - want).abs().max().item())
        B, L, D, N = dims
        print(f"  selective_scan B={B} L={L} D={D} N={N}: plan {plan(B, D, N)}, "
              f"max abs err {(got - want).abs().max().item()}")
    print(f"K3 selective_scan: {len(SCAN_SHAPES)} shapes, fwd and reverse, agree after a NaN "
          f"fill of shared memory; max abs err {err}")
    return err


def _rnn_inputs(torch, gen, n_gates, B, T, Hd, L):
    """Gate inputs and weights drawn like the model's: U(-1/sqrt(H), 1/sqrt(H))."""
    k, GH = Hd ** -0.5, n_gates * Hd
    xp = torch.randn(B, T, GH, generator=gen)
    ws = [(torch.rand(s, generator=gen) * 2 - 1) * k
          for s in ((L, Hd, GH), (L, GH), (L - 1, Hd, GH), (L - 1, GH))]
    return [t.cuda() for t in [xp] + ws]


# K2/K5 shapes of the forward check added with "clusters" (B, T, H, L).
RNN_CLUSTER_SHAPES = [(5, 20, 97, 2), (32, 40, 128, 4), (33, 12, 256, 2), (2, 150, 128, 2)]


def _rnn_design(Hd: int) -> str:
    """The K2/K5 design, forward and backward, at width Hd: "registers" up
    to 64, "clusters" up to 256 (H_max), "columns" above."""
    return "registers" if Hd <= 64 else "clusters" if Hd <= 256 else "columns"


def _check_rnn(torch, gen):
    from vct_torch.ops import lstm as ops
    from vct_torch.ops._build import fill_shared_memory

    def stale(op, *args):
        """``op`` launched after NaN was left in every SM's shared memory."""
        fill_shared_memory(float("nan"))
        return op(*args)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = dict.fromkeys(("lstm_stack", "gru_stack", "lstm_scan", "gru_scan"), 0.0)
    # (B, T, H, L): the bench stack, a served request, one video; the
    # register design's edges (H=64 at L=4, the largest plan; the default
    # width H=32 at T=60; T=130 over three staged chunks; H=16, the widest
    # LSTM with two k-slices per gate column); the "clusters" design (H=65,
    # its first width; H=96 and 97, not multiples of a cluster's CTAs, 97
    # with rows left over in the last cluster; H=128 at the bench batch, the
    # H = 128 phase's width; H=256, its widest, at B=2 and at B=33, four
    # rows a cluster and one over; H=128 at T=150, over staged chunks);
    # "columns" above H = 256 (H=512, T=128: the previous layer's outputs
    # through L2 too); an odd H, T=1.
    shapes = [(32, 40, 56, 4), (4, 40, 56, 4), (1, 40, 56, 4), (2, 16, 64, 4), (32, 60, 32, 3),
              (2, 130, 17, 3), (3, 40, 16, 4), (2, 16, 65, 2), (2, 16, 96, 2), RNN_CLUSTER_SHAPES[0],
              RNN_CLUSTER_SHAPES[1], (2, 16, 256, 2), *RNN_CLUSTER_SHAPES[2:], (1, 128, 512, 2),
              (3, 7, 5, 3), (2, 1, 56, 2)]
    # The shapes added with "clusters" draw from a generator of their own, so
    # that every later phase draws what it drew before them.
    own = torch.Generator().manual_seed(22)
    for cell, n_gates in (("lstm", 4), ("gru", 3)):
        stack, scan = getattr(ops, f"{cell}_stack"), getattr(ops, f"{cell}_scan")
        scan_ref = getattr(ops, f"{cell}_scan_ref")
        for B, T_, Hd, L in shapes:
            g = own if (B, T_, Hd, L) in RNN_CLUSTER_SHAPES else gen
            xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, g, n_gates, B, T_, Hd, L)
            cases = [
                (f"{cell}_stack", L, stale(stack, xp, w_hh, b_hh, w_ih, b_ih),
                 ops.stack_ref(xp, w_hh, b_hh, w_ih, b_ih)),
                (f"{cell}_scan", 1, stale(scan, xp, w_hh[0], b_hh[0]),
                 scan_ref(xp, w_hh[0], b_hh[0])),
            ]
            if (B, T_, Hd) == (32, 40, 56):  # K5 through the flip, as the reverse direction runs
                flip = torch.flip(xp, dims=(1,))
                cases.append((f"{cell}_scan", 1,
                              torch.flip(stale(scan, flip, w_hh[1], b_hh[1]), dims=(1,)),
                              torch.flip(scan_ref(flip, w_hh[1], b_hh[1]), dims=(1,))))
            torch.cuda.synchronize()
            for name, layers, got, want in cases:
                design = ops.design(T_, Hd, layers, n_gates)
                if design != _rnn_design(Hd):
                    raise AssertionError(f"{name} H={Hd}: took the {design} design")
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                err = (got - want).abs().max().item()
                errs[name] = max(errs[name], err)
                shown = f" L={layers}" if name.endswith("stack") else ""
                plan = (f", plan {ops.plan(B, T_, Hd, layers, n_gates)}"
                        if design == "clusters" else "")
                print(f"  {name} B={B} T={T_} H={Hd}{shown}: design {design}{plan}, max abs err "
                      f"{err}")
    print(f"K2/K5 lstm/gru stack and scan: {len(shapes)} shapes each agree; max abs err {errs}")
    return errs


# Backward checks: each gradient within BWD_RTOL of its largest magnitude of
# autograd through the plain version (f32, other summation orders).
BWD_RTOL = 1e-5
# K2 backward shapes (B, T, H, L): the bench stack, a request, the default
# width; the register design's edges H = 1, 5, 17 (odd), 64 (its widest
# plan) and T = 130 (three chunks); "clusters" at H = 65 and 256 (the
# timed rows), 97 with rows left over in its last cluster, 128 at the bench
# batch and over staged chunks (T = 130); "columns" above H_max (H = 272).
BWD_LONG_T = 130
# K3 backward shapes (B, L, D, N): the deployed step, VideoMamba's width,
# N = 1, 24, 64, 100 at the deployed widths of a request, L = 130 (three
# chunks: a first pass keeps h at the later chunks' starts), N = 300 (two
# state tiles) and the VideoMamba model's train step and a B=4 batch (T=16).
# The deployed step and L = 130 run in both directions.
BWD_SCAN_SHAPES = ([(32, T, 16, 32), (2, 256, 2048, 16)] + [(4, T, 16, n) for n in (1, 24, 64, 100)]
                   + [(4, BWD_LONG_T, 16, 32), (4, T, 16, 300), (32, 16, 2048, 16),
                      (4, 16, 2048, 16)])
BWD_SCAN_BOTH_WAYS = (BWD_SCAN_SHAPES[0], (4, BWD_LONG_T, 16, 32))
# VideoMamba's shape (n_state 16, d_inner 2048 at L = 256), timed beside the
# deployed step.
VIDEOMAMBA_SCAN = (2, 256, 2048, 16)
# K3 in the VideoMamba model's bench and train steps: B=32, T=16, d_inner
# 2048, n_state 16.
VIDEOMAMBA_STEP = (32, 16, 2048, 16)
# K2's backward above H = 64 ("clusters") at the two widths the forward is
# timed at (the forward's H=256 row takes input 256 = H, the width cuDNN's
# backward is built with).
BWD_WIDE_SHAPES = [(32, 40, 65, 4), (2, 16, 256, 2)]
# Those added with "clusters", drawn from a generator of their own (as the
# forward's RNN_CLUSTER_SHAPES).
BWD_CLUSTER_SHAPES = [(5, 20, 97, 2), (32, 40, 128, 4), (2, BWD_LONG_T, 128, 2), (2, 12, 272, 2)]
BWD_RNN_SHAPES = [(32, 40, 56, 4), (4, 40, 56, 4), (32, 60, 32, 3), (3, 7, 5, 3), (2, 20, 17, 3),
                  (2, 16, 1, 2), (2, 16, 64, 4), (2, BWD_LONG_T, 17, 3), (2, 16, 65, 2),
                  *BWD_WIDE_SHAPES, *BWD_CLUSTER_SHAPES]
# The backward entry points and the vct custom_vjp backward each replaces
# (plain JAX there, no Pallas kernel).
BWD_KERNELS = {
    "selective_scan_bwd": ("vct_torch/csrc/selective_scan_bwd.cu",
                           "vct/ops/selective_scan_pallas.py:102"),
    "lstm_stack_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:327"),
    "gru_stack_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:327"),
    "lstm_scan_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:343"),
    "gru_scan_bwd": ("vct_torch/csrc/lstm_bwd.cu", "vct/ops/lstm_pallas.py:343"),
}


def _bwd_spills(log: str) -> dict:
    """Spill-store bytes ptxas reports for each register-design instance of
    the backward (``rnn_bwd_reg_kernel<G, KU, S, NQ>``): the library builds
    only those the design takes. Raises if the log holds none."""
    found = {}
    for line in _ptxas_lines(log):
        m = re.search(r"rnn_bwd_reg_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m:
            found[tuple(map(int, m.groups()))] = int(re.search(r"(\d+) bytes spill stores",
                                                               line).group(1))
    if not found:
        raise AssertionError("no ptxas line for a backward register instance")
    return found


def _grads_close(torch, what, got, want, names) -> tuple[float, float]:
    """Each gradient within BWD_RTOL of its largest magnitude; returns the
    largest error over that magnitude and the largest absolute error."""
    worst, worst_abs = 0.0, 0.0
    for name, g, w in zip(names, got, want):
        if g is None:
            raise AssertionError(f"{what} d{name}: no gradient")
        scale, err = w.abs().max().item(), (g - w).abs().max().item()
        if not (err <= BWD_RTOL * scale if scale > 0 else err == 0):
            raise AssertionError(f"{what} d{name}: max abs err {err} against {BWD_RTOL} x {scale}")
        worst, worst_abs = max(worst, err / scale if scale > 0 else 0.0), max(worst_abs, err)
    return worst, worst_abs


def _replay_equal(torch, fn) -> bool:
    """``fn`` (returning a tuple of tensors) run twice and replayed once from
    a CUDA graph, each launch after a NaN fill: all bit-equal."""
    from vct_torch.ops._build import fill_shared_memory

    runs = []
    for _ in range(2):
        fill_shared_memory(float("nan"))
        runs.append([t.clone() for t in fn()])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    fill_shared_memory(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    runs.append([t.clone() for t in out])
    return all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))


def _check_backward(torch, gen) -> dict:
    """Every backward kernel against autograd through its plain version,
    each launch just after NaN was left in every SM's shared memory; two
    runs and a graph replay bit-equal. Returns the largest relative errors."""
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3
    from vct_torch.ops._build import fill_shared_memory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {n: (0.0, 0.0) for n in BWD_KERNELS}

    def note(name, err):
        errs[name] = tuple(max(a, b) for a, b in zip(errs[name], err))
        return err[0]

    for dims in BWD_SCAN_SHAPES:
        args = _scan_inputs(torch, gen, *dims)
        gy = torch.randn(dims[:3], generator=gen).cuda()
        print(f"  selective_scan_bwd B,L,D,N={dims}: plan {k3.bwd_plan(*dims)}")
        for reverse in ((False, True) if dims in BWD_SCAN_BOTH_WAYS else (False,)):
            leaves = [a.clone().requires_grad_(True) for a in args]
            y = k3.selective_scan(*leaves, reverse=reverse)
            fill_shared_memory(float("nan"))
            got = torch.autograd.grad(y, leaves, gy)
            want = k3.selective_scan_bwd_ref(*args, gy, reverse=reverse)
            torch.cuda.synchronize()
            err = note("selective_scan_bwd", _grads_close(
                torch, f"selective_scan_bwd {dims} reverse={reverse}", got, want,
                ("u", "delta", "A", "B", "C")))
            print(f"  selective_scan_bwd B,L,D,N={dims} reverse={reverse}: max err / max |grad| "
                  f"{err}")
        if dims == BWD_SCAN_SHAPES[0]:
            if not _replay_equal(torch, lambda: k3.selective_scan_bwd(*args, gy)):
                raise AssertionError("selective_scan_bwd: runs or graph replay not bit-equal")

    def stale(fn):
        def wrapped(*a):
            fill_shared_memory(float("nan"))
            return fn(*a)
        return wrapped

    own = torch.Generator().manual_seed(22)
    with mock.patch.object(ops, "_layer_bwd", stale(ops._layer_bwd)):
        for cell, n_gates in (("lstm", 4), ("gru", 3)):
            for B, T_, Hd, L in BWD_RNN_SHAPES:
                g = own if (B, T_, Hd, L) in BWD_CLUSTER_SHAPES else gen
                args = _rnn_inputs(torch, g, n_gates, B, T_, Hd, L)
                gy = torch.randn(B, T_, Hd, generator=g).cuda()
                leaves = [a.clone().requires_grad_(True) for a in args]
                got = torch.autograd.grad(getattr(ops, f"{cell}_stack")(*leaves), leaves, gy)
                want = ops.stack_bwd_ref(*args, gy)
                err = note(f"{cell}_stack_bwd", _grads_close(
                    torch, f"{cell}_stack_bwd {(B, T_, Hd, L)}", got, want,
                    ("xp0", "w_hh", "b_hh", "w_ih", "b_ih")))
                design = ops.bwd_design(T_, Hd, n_gates)
                if design != _rnn_design(Hd):
                    raise AssertionError(f"{cell}_stack_bwd H={Hd}: took the {design} design")
                plan = (f", plan {ops.plan(B, T_, Hd, L, n_gates, backward=True)}"
                        if design == "clusters" else "")
                print(f"  {cell}_stack_bwd B,T,H,L={(B, T_, Hd, L)}: design {design}{plan}, "
                      f"max err / max |grad| {err}")
                if (B, T_, Hd) == (32, 40, 56):
                    y, hs, _ = ops._launch(f"{cell}_stack", n_gates, *args, save=True)
                    bwd = getattr(ops, f"{cell}_stack_bwd")
                    if not _replay_equal(torch, lambda: bwd(*args, hs, y, gy)):
                        raise AssertionError(f"{cell}_stack_bwd: runs or graph replay not "
                                             f"bit-equal")
                    # K5, both directions (the reverse one through the time flip)
                    for flip in (False, True):
                        xp = torch.flip(args[0], dims=(1,)) if flip else args[0]
                        leaves = [t.clone().requires_grad_(True) for t in (xp, args[1][0],
                                                                            args[2][0])]
                        got = torch.autograd.grad(getattr(ops, f"{cell}_scan")(*leaves), leaves,
                                                  gy)
                        want = ops.scan_bwd_ref(xp, args[1][0], args[2][0], gy)
                        err = note(f"{cell}_scan_bwd", _grads_close(
                            torch, f"{cell}_scan_bwd flip={flip}", got, want,
                            ("xp", "w_hh", "b_hh")))
                        print(f"  {cell}_scan_bwd B,T,H=(32, 40, 56) flip={flip}: max err / "
                              f"max |grad| {err}")
                    y1, _, _ = ops._launch(f"{cell}_scan", n_gates, args[0], args[1][0], args[2][0])
                    sbwd = getattr(ops, f"{cell}_scan_bwd")
                    if not _replay_equal(torch, lambda: sbwd(args[0], args[1][0], args[2][0], y1,
                                                             gy)):
                        raise AssertionError(f"{cell}_scan_bwd: runs or graph replay not bit-equal")
    print(f"backward kernels: K3 at {len(BWD_SCAN_SHAPES)} shapes, K2 at {len(BWD_RNN_SHAPES)} "
          f"shapes a cell, K5 both directions, each after a NaN fill of shared memory, within "
          f"{BWD_RTOL} of each gradient's largest magnitude; two runs and a graph replay "
          f"bit-equal; largest (err / max |grad|, abs err) {errs}")
    return errs


def _synthetic_videos(lengths, seed):
    """Decoded uint8 videos with static runs (tied SAD scores) and noisy runs."""
    rng = np.random.RandomState(seed)
    videos = []
    for n in lengths:
        frames, scene = [], rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
        while len(frames) < n:
            run = rng.randint(1, 7)
            noisy = rng.rand() < 0.5
            for _ in range(run):
                f = scene
                if noisy:
                    f = np.clip(scene.astype(np.int16) + rng.randint(-8, 9, scene.shape), 0, 255)
                frames.append(f.astype(np.uint8))
            scene = rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
        videos.append(np.stack(frames[:n]))
    return videos


def _set_scan_impl(model, impl):
    """Switch the temporal head between the kernels ("pallas") and their
    plain versions ("scan")."""
    from vct_torch.models.recurrent import GRU, LSTM
    from vct_torch.models.ssm import ParallelMamba

    for m in model.modules():
        if isinstance(m, (ParallelMamba, LSTM, GRU)):
            m.scan_impl = impl


def _check_served(results, names):
    if [r["video_name"] for r in results] != names:
        raise AssertionError("served results do not match the requests")
    for r in results:
        scores = np.asarray(r["scores"])
        if not (np.isfinite(scores).all() and abs(scores.sum() - 1.0) < 1e-5):
            raise AssertionError(f"bad probabilities for {r['video_name']}: {scores}")


def _selection_gaps(torch, preprocess, raw, lens, seq_len, method, rows):
    """Print, for each clip in ``rows``, the score gap at the selection
    boundary under the kernel and under the plain scorer."""
    from vct_torch.ops.pair_scores import pair_scores_ref
    from vct_torch.ops.ssim import ssim_pair_scores_ref

    if method == "ssim":
        scorers = {"kernel": lambda r: 1.0 - preprocess.ssim_pair_scores(r),
                   "plain": lambda r: 1.0 - ssim_pair_scores_ref(r)}
    else:
        scorers = {"kernel": lambda r: preprocess.pair_scores(r, method),
                   "plain": lambda r: pair_scores_ref(r, method)}
    k = seq_len - 1 if method == "ssim" else seq_len  # transitions kept
    t = torch.arange(raw.shape[1] - 1, device=raw.device)[None, :]
    for name, score in scorers.items():
        s = torch.where(t < (lens - 1)[:, None], score(raw), float("-inf"))
        top = torch.sort(s, dim=-1, descending=True).values
        for b in rows:
            gap = (top[b, k - 1] - top[b, k]).item()
            print(f"  clip {b} {name}: score gap at the boundary {gap}")


def _bench_and_hold(torch, model, cfg32, seq_len, gpu, label, seed, method="sad"):
    """Time a bench-shaped step (B=32, raw L=2T, ragged lengths, ``method``
    selection, forward) as clips/s; hold the kernel path against the plain
    path, and an f32 copy of the model on the card against the CPU. Returns
    the timings it prints."""
    import vct_torch.data.preprocess as preprocess
    from vct_torch.models import build_model
    from vct_torch.ops.pair_scores import pair_scores_ref
    from vct_torch.ops.ssim import ssim_pair_scores_ref

    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, 256, (32, 2 * seq_len, H, W, 3), dtype=np.uint8)).cuda()
    lens = torch.from_numpy(rng.randint(seq_len + 1, 2 * seq_len + 1, size=32)).cuda()

    def sample():
        return preprocess.device_sample_clips(raw, seq_len, method=method, lengths=lens)

    torch.backends.cudnn.deterministic = False
    with torch.inference_mode():
        x = sample()
        feats = model(x, features_only=True)
        step_ms = _events_ms(torch, lambda: model(sample()), iters=10)
        sample_ms = _events_ms(torch, sample, iters=10)
        forward_ms = _events_ms(torch, lambda: model(x), iters=10)
        backbone_ms = _events_ms(torch, lambda: model(x, features_only=True), iters=10)
        head_ms = _events_ms(torch, lambda: model(feats, from_features=True), iters=10)
    timing = {
        "config": label, "serving_clips_per_s": 32 * 1e3 / step_ms, "batch": 32,
        "sampling": method,
        "raw_len": 2 * seq_len, "T": seq_len, "ms_per_batch": step_ms, "sampling_ms": sample_ms,
        "forward_ms": forward_ms, "backbone_ms": backbone_ms, "head_ms": head_ms, "gpu": gpu,
    }
    print(json.dumps(timing))

    # --- kernel path vs the same path with the plain versions ------------
    scorer = {"sad": ("pair_scores", pair_scores_ref),
              "ssim": ("ssim_pair_scores", ssim_pair_scores_ref)}[method]
    torch.backends.cudnn.deterministic = True  # same conv algorithms on both paths
    with torch.inference_mode():
        idx_k = preprocess.sample_indices(raw, seq_len, method, lens)
        logits_k = model(sample())
        _set_scan_impl(model, "scan")
        with mock.patch.object(preprocess, *scorer):
            idx_p = preprocess.sample_indices(raw, seq_len, method, lens)
            logits_p = model(sample())
        _set_scan_impl(model, "pallas")
    if not torch.equal(idx_k, idx_p):
        rows = sorted({int(b) for b in (idx_k != idx_p).any(dim=1).nonzero()[:, 0]})
        with torch.inference_mode():
            _selection_gaps(torch, preprocess, raw, lens, seq_len, method, rows)
        raise AssertionError(f"{label}: kernel and plain {method} selection picked different "
                             f"frames in clips {rows}")
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
    print(f"{label}: kernel path == plain path: frame indices equal, logits max abs err "
          f"{(logits_k - logits_p).abs().max().item()}")
    torch.backends.cudnn.deterministic = False

    # --- the card against the CPU, f32, same seed -------------------------
    with torch.inference_mode():
        on_card = build_model(cfg32, seq_len, seed=0)(sample()[:2]).cpu()
        x_cpu = preprocess.device_sample_clips(raw[:2].cpu(), seq_len, method=method,
                                               lengths=lens[:2].cpu())
        on_cpu = build_model(cfg32, seq_len, device="cpu", seed=0)(x_cpu)
    torch.testing.assert_close(on_card, on_cpu, atol=1e-3, rtol=1e-3)
    print(f"{label}: f32 card vs CPU logits max abs err {(on_card - on_cpu).abs().max().item()}")
    return timing


def _serve_counters():
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops.pair_scores import pair_scores
    from vct_torch.ops.preprocess import normalize_frames
    from vct_torch.ops.selective_scan import selective_scan
    from vct_torch.ops.ssim import ssim_pair_scores

    return {"pair_scores": pair_scores, "ssim_pair_scores": ssim_pair_scores,
            "normalize_frames": normalize_frames, "selective_scan": selective_scan,
            **{n: getattr(rnn_ops, n) for n in RNN_KERNELS}}


# Decoded lengths of the served videos, four a request: short ones are
# cycled up to T, the others go through a length bucket and on-device
# selection.
SERVED_LENGTHS = [40, 75, 121, 200, 60, 100, 150, 55, 120, 61, 180, 90]


def _serve_counted(torch, label, model, class_names, seq_len, samplings, seed, mamba_blocks):
    """One request of four decoded videos for each entry of ``samplings``
    (its selection method), through ``sample_decoded_clips`` and
    ``classify_and_display`` (its JSON kept off the log), the kernels'
    launches read around exactly that run and held to the scorer's (K1 for
    SAD and flow, K4 for SSIM) once a video longer than ``seq_len``, K3
    ``mamba_blocks`` times a request, every other kernel never."""
    import contextlib
    import io

    from vct_torch.serve.deployment import (_DEVICE_METHODS, classify_and_display,
                                            sample_decoded_clips)

    lengths = SERVED_LENGTHS[:4 * len(samplings)]
    videos = _synthetic_videos(lengths, seed=seed)
    names = [f"@user{i}_video_{1000 + i}.mp4" for i in range(len(videos))]
    counters = _serve_counters()
    for fn in counters.values():
        fn.launches = 0
    results = []
    with contextlib.redirect_stdout(io.StringIO()):
        for r, sampling in enumerate(samplings):
            batch = slice(4 * r, 4 * r + 4)
            clips = sample_decoded_clips(videos[batch], sampling, seq_len)
            results += classify_and_display(model, clips, names[batch], class_names,
                                            batch_size=4)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    scorer = "ssim_pair_scores" if _DEVICE_METHODS[samplings[0]] == "ssim" else "pair_scores"
    want[scorer] = sum(n > seq_len for n in lengths)
    want["selective_scan"] = len(samplings) * mamba_blocks
    print(f"{label} path ({', '.join(samplings)}): labels {[r['labels'][0] for r in results]}; "
          f"launches {_nonzero(launches)} (expected {_nonzero(want)})")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} != expected {want}")
    _check_served(results, names)
    return launches


def _serve_deployed(torch, gpu, model, samplings, label):
    """The deployed model serves three requests of four decoded videos each,
    request r with ``samplings[r]``; the kernels' launch counts are read
    around exactly that run. Then the bench-shaped step is timed and held."""
    from vct_torch.core.config import ModelConfig
    from vct_torch.serve.deployment import _DEVICE_METHODS

    class_names = [f"class_{i}" for i in range(ModelConfig(**DEPLOYED).num_classes)]
    launches = _serve_counted(torch, label, model, class_names, T, samplings, seed=0,
                              mamba_blocks=DEPLOYED["rnn_layer"])
    _bench_and_hold(torch, model, ModelConfig(**DEPLOYED), T, gpu, label, seed=1,
                    method=_DEVICE_METHODS[samplings[0]])
    return launches


def _recurrent_path(torch, gpu):
    """Four LSTM/GRU heads at the UCF50 geometry, one request each."""
    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops.pair_scores import pair_scores
    from vct_torch.serve.deployment import classify_and_display, sample_decoded_clips

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vct_torch.ops.preprocess import normalize_frames
    from vct_torch.ops.ssim import ssim_pair_scores

    counters = {"pair_scores": pair_scores, "ssim_pair_scores": ssim_pair_scores,
                "normalize_frames": normalize_frames,
                **{n: getattr(rnn_ops, n) for n in RNN_KERNELS}}
    lengths = [30, 75, 121, 200]
    videos = _synthetic_videos(lengths, seed=2)
    names = [f"@user{i}_video_{2000 + i}.mp4" for i in range(len(videos))]
    totals = dict.fromkeys(counters, 0)
    for rnn_type, bidirectional in (("lstm", False), ("gru", False), ("lstm", True), ("gru", True)):
        cfg = ModelConfig(**UCF50, rnn_type=rnn_type, bidirectional=bidirectional,
                          compute_dtype="bfloat16")
        model = build_model(cfg, T_UCF50, seed=0)
        for fn in counters.values():
            fn.launches = 0
        clips = sample_decoded_clips(videos, "sad", T_UCF50)
        results = classify_and_display(model, clips, names,
                                       [f"class_{i}" for i in range(cfg.num_classes)], batch_size=4)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want["pair_scores"] = sum(n > T_UCF50 for n in lengths)
        if bidirectional:  # K5 per layer and direction
            want[f"{rnn_type}_scan"] = 2 * cfg.rnn_layer
        else:  # the whole stack in one K2 launch
            want[f"{rnn_type}_stack"] = 1
        head = f"{rnn_type} {'bidir' if bidirectional else 'uni'}"
        print(f"{head} path launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{head}: kernel launches {launches} != expected {want}")
        _check_served(results, names)
        totals = {n: totals[n] + launches[n] for n in totals}
        del model
    model = build_model(ModelConfig(**UCF50, rnn_type="lstm", compute_dtype="bfloat16"),
                        T_UCF50, seed=0)
    _bench_and_hold(torch, model, ModelConfig(**UCF50, rnn_type="lstm"), T_UCF50, gpu,
                    "ucf50_lstm", seed=3)
    return totals


# The training path: both served configurations at full width, trained at
# the bench batch (bench.py's train mode) on synthetic clips; 40 samples
# split 32 / 8: one bench batch a step.
TRAIN_CONFIGS = {"deployed_mamba": (DEPLOYED, T), "ucf50_lstm": ({**UCF50, "rnn_type": "lstm"},
                                                                 T_UCF50)}
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_EPOCHS = 32, 40, 2
# Relative agreement of the kernel and plain training paths over 5 Adam steps.
TRAIN_RTOL = 1e-4


def _train_counters():
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops import selective_scan as k3

    return {"selective_scan": k3.selective_scan, "selective_scan_bwd": k3.selective_scan_bwd,
            **{n: getattr(rnn_ops, n) for n in RNN_KERNELS},
            **{n: getattr(rnn_ops, n) for n in BWD_KERNELS if n != "selective_scan_bwd"}}


def _expected_train_launches(model: dict, forwards: int, backwards: int) -> dict:
    """Kernel launches of ``forwards`` forward passes and ``backwards``
    backward passes of the head: a Mamba head (the LRCN's, or VideoMamba's)
    one K3 forward and one K3 backward a block; the unidirectional LSTM/GRU stack one K2 forward and
    one backward launch a layer; a bidirectional one K5 forward and backward
    a layer and direction."""
    from vct_torch.core.config import ModelConfig

    want = dict.fromkeys(_train_counters(), 0)
    cfg = ModelConfig(**model)
    if cfg.model_family == "videomamba":  # its Mamba blocks
        layers, rnn = cfg.vm_n_layer, "mamba"
    else:
        layers, rnn = cfg.rnn_layer, cfg.rnn_type
    if rnn == "mamba":
        want["selective_scan"] = forwards * layers
        want["selective_scan_bwd"] = backwards * layers
    elif cfg.bidirectional:  # K5 a layer and direction, both ways
        want[f"{rnn}_scan"] = forwards * 2 * layers
        want[f"{rnn}_scan_bwd"] = backwards * 2 * layers
    else:
        want[f"{rnn}_stack"] = forwards
        want[f"{rnn}_stack_bwd"] = backwards * layers
    return want


def _train_cli(torch, label, model: dict, seq_len: int) -> dict:
    """``python -m vct_torch.train``'s main on synthetic data at full width:
    its epoch lines and metric block, checked by ``extract_metrics``, and the
    kernels' launches around exactly that run."""
    import contextlib
    import io
    import tempfile

    from vct_torch.core.metrics_contract import extract_metrics
    from vct_torch.train.__main__ import main as train_main

    argv = ["--data.synthetic", "true", "--data.synthetic_samples", str(TRAIN_SAMPLES),
            "--data.sequence_length", str(seq_len), "--train.epochs", str(TRAIN_EPOCHS),
            "--train.batch_size", str(TRAIN_BATCH), "--model.compute_dtype", "bfloat16"]
    for key, value in model.items():
        argv += [f"--model.{key}", str(value)]
    counters = _train_counters()
    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters.values():
            fn.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_main(argv + ["--train.model_path", tmp])
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
    text = out.getvalue()
    print("\n".join(f"  | {line}" for line in text.splitlines()))
    metrics = extract_metrics(text)
    epochs = sum(line.startswith("Epoch ") for line in text.splitlines())
    if rc != 0 or epochs != TRAIN_EPOCHS or "Model saved to" not in text:
        raise AssertionError(f"{label}: train main rc {rc}, {epochs} epoch lines")
    n_test = int(round(TRAIN_SAMPLES * 0.2))
    steps = TRAIN_EPOCHS * -(-(TRAIN_SAMPLES - n_test) // TRAIN_BATCH)
    want = _expected_train_launches(model, steps + -(-n_test // TRAIN_BATCH), steps)
    print(f"{label} train main: accuracy {metrics.accuracy}, trainable params "
          f"{metrics.trainable_params}; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: train launches {launches} != expected {want}")
    return launches


def _train_hold_and_time(torch, gen, gpu, label, model: dict, seq_len: int) -> dict:
    """From the same weights, dropout 0, TF32 off: five Adam steps of the
    head on the same backbone features through the kernels and through the
    plain versions (``_set_scan_impl``), losses and parameters within
    TRAIN_RTOL; every trained parameter's gradient on the kernel path
    (the declared-but-unread Mamba ``D`` excepted) within BWD_RTOL of its
    largest magnitude of the plain path's; then the steady-state train step
    at the bench batch, timed by CUDA events, with its launches a step."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    overrides = {"data.sequence_length": str(seq_len), "train.batch_size": str(TRAIN_BATCH),
                 "model.compute_dtype": "bfloat16", "model.dropout": "0.0",
                 **{f"model.{k}": str(v) for k, v in model.items()}}
    cfg = Config().replace(**overrides)
    names = [f"class_{i}" for i in range(cfg.model.num_classes)]
    trainer = Trainer(cfg, names)
    net = trainer.model
    start = {k: v.clone() for k, v in net.state_dict().items()}
    clips = torch.rand(TRAIN_BATCH, seq_len, H, W, 3, generator=gen).cuda()
    labels = [torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
              for _ in range(5)]
    mask = torch.ones(TRAIN_BATCH, device=clips.device)
    with torch.no_grad():
        feats = net.eval()(clips, features_only=True)
    trainer._feature_mode = True
    runs = {}
    for impl in ("pallas", "scan"):
        net.load_state_dict(start)
        _set_scan_impl(net, impl)
        net.train()
        loss = trainer._loss_fn(net(feats, from_features=True), labels[0], mask)[0]
        grads = torch.autograd.grad(loss, trainer._trained, allow_unused=True)
        state = trainer.init_state()
        losses, floor = [], [torch.zeros_like(p, dtype=torch.bool) for p in trainer._trained]
        for y in labels:
            losses.append(trainer._train_step(state, feats, y, mask)[0].item())
            for f, p in zip(floor, trainer._trained):
                f |= p.grad.abs() < BWD_RTOL * p.grad.abs().max()
        runs[impl] = (grads, losses, [p.detach().clone() for p in trainer._trained], floor)
    _set_scan_impl(net, "pallas")
    names_trained = [n for n, p in net.named_parameters() if p.requires_grad]
    (g_k, l_k, p_k, f_k), (g_p, l_p, p_p, f_p) = runs["pallas"], runs["scan"]
    for n, a, b in zip(names_trained, g_k, g_p):
        if n.endswith(".mixer.D"):
            if a is not None or b is not None:
                raise AssertionError(f"{label}: {n} is declared unused, yet has a gradient")
            continue
        _grads_close(torch, f"{label} kernel-path gradient of", [a], [b], [n])
    # Parameters: each tensor's difference, in norm, within TRAIN_RTOL of its
    # norm, over the elements whose gradient stayed above BWD_RTOL of the
    # tensor's largest on both paths at every step. Below that floor the
    # two paths' gradients are f32 noise and Adam's normalised step follows
    # the noise's sign: those elements are held to the most two Adam
    # trajectories can part by, 2 lr a step.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_k, l_p))
    bound = 2 * cfg.train.learning_rate * len(labels)
    param_err, raw_err, at_floor, n_elems = 0.0, 0.0, 0, 0
    for n, a, b, fa, fb in zip(names_trained, p_k, p_p, f_k, f_p):
        floor = fa | fb
        keep = ~floor
        raw_err = max(raw_err, ((a - b).norm() / b.norm()).item())
        if keep.any():
            param_err = max(param_err, ((a - b)[keep].norm() / b[keep].norm()).item())
        if not bool(((a - b).abs()[floor] <= bound).all()):
            raise AssertionError(f"{label}: {n} moved apart beyond Adam's bound {bound}")
        at_floor, n_elems = at_floor + int(floor.sum()), n_elems + floor.numel()
    if not (loss_err <= TRAIN_RTOL and param_err <= TRAIN_RTOL):
        raise AssertionError(f"{label}: 5 Adam steps, kernel vs plain: losses rel err {loss_err}, "
                             f"parameters rel err {param_err}, over {TRAIN_RTOL}")
    print(f"{label}: every trained parameter's gradient on the kernel path within {BWD_RTOL} of "
          f"the plain path's ({len(names_trained)} tensors); 5 Adam steps, losses {l_k} "
          f"against {l_p}: largest rel err {loss_err}; parameters (norm, above the gradients' "
          f"noise floor) {param_err}, all elements {raw_err}; {at_floor} of {n_elems} elements "
          f"at the floor, within {bound}")

    # --- the steady-state train step at the bench batch ---------------------
    trainer._feature_mode = False
    net.load_state_dict(start)
    state = trainer.init_state()
    step = lambda: trainer._train_step(state, clips, labels[0], mask)  # noqa: E731
    counters = _train_counters()
    step_ms = _events_ms(torch, step, iters=5, warmup=2)
    for fn in counters.values():
        fn.launches = 0
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    per_step = {n: fn.launches / 3 for n, fn in counters.items()}
    want = _expected_train_launches(model, 1, 1)
    if per_step != want:
        raise AssertionError(f"{label}: launches a train step {per_step} != expected {want}")
    with torch.no_grad():
        backbone_ms = _events_ms(torch, lambda: net(clips, features_only=True), iters=5)
    trainer._feature_mode = True
    head_ms = _events_ms(torch, lambda: trainer._train_step(state, feats, labels[0], mask), iters=10)
    trainer._feature_mode = False
    breakdown = _profile_groups(torch, step, 3)
    out = {"config": label, "train_step_ms": step_ms, "train_clips_per_s": TRAIN_BATCH * 1e3 / step_ms,
           "batch": TRAIN_BATCH, "T": seq_len, "backbone_forward_ms": backbone_ms,
           "head_step_ms": head_ms, "launches_per_step": per_step,
           "expected_launches_per_step": want, "device_breakdown": breakdown, "gpu": gpu}
    print(json.dumps(out))
    del trainer, net
    torch.cuda.empty_cache()
    return out


def _profile_groups(torch, fn, steps: int) -> dict:
    """Device time a step of ``fn`` by kernel, from ``torch.profiler`` over
    ``steps`` calls: the twelve largest, their total, and the step's wall
    time (busy share = device / wall); None where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():  # the kernels themselves, not the ops that launched them
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev:
            rows.append((e.key, dev / 1e3 / steps))
    if not rows:
        return {"device_ms": None, "wall_ms": wall}
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    return {"device_ms": total, "wall_ms": wall, "busy_share": total / wall,
            "top": [[k[:80], ms] for k, ms in rows[:12]]}


def _train_heads(torch, gen) -> dict:
    """One train step at the bench batch for each other head of the UCF50
    geometry (GRU, and LSTM and GRU bidirectional), launch counts read
    around it: K2's GRU backward and K5's backward on a training path."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    counters = _train_counters()
    totals = dict.fromkeys(counters, 0)
    ucf50 = {**UCF50, "compute_dtype": "bfloat16"}
    for rnn_type, bidirectional in (("gru", False), ("lstm", True), ("gru", True)):
        model = {**ucf50, "rnn_type": rnn_type, "bidirectional": bidirectional}
        cfg = Config().replace(**{"data.sequence_length": str(T_UCF50),
                                  **{f"model.{k}": str(v) for k, v in model.items()}})
        trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
        state = trainer.init_state()
        clips = torch.rand(TRAIN_BATCH, T_UCF50, H, W, 3, generator=gen).cuda()
        labels = torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
        for fn in counters.values():
            fn.launches = 0
        loss = trainer._train_step(state, clips, labels, torch.ones(TRAIN_BATCH, device="cuda"))[0]
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = _expected_train_launches(model, 1, 1)
        head = f"{rnn_type} {'bidir' if bidirectional else 'uni'}"
        print(f"{head} train step: loss {loss.item()}, launches {launches} (expected {want})")
        if launches != want or not np.isfinite(loss.item()):
            raise AssertionError(f"{head}: train step launches {launches} != expected {want}")
        totals = {n: totals[n] + launches[n] for n in totals}
        del trainer, state
    torch.cuda.empty_cache()
    return totals


def _train_path(torch, gen, gpu) -> dict:
    """Both configurations through the train CLI, the kernel/plain hold and
    the timed step, then a step of each other UCF50 head; returns the summed
    launches of the CLI runs and those steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    totals = dict.fromkeys(_train_counters(), 0)
    for label, (model, seq_len) in TRAIN_CONFIGS.items():
        launches = _train_cli(torch, label, model, seq_len)
        totals = {n: totals[n] + launches[n] for n in totals}
        _train_hold_and_time(torch, gen, gpu, label, model, seq_len)
    launches = _train_heads(torch, gen)
    return {n: totals[n] + launches[n] for n in totals}


# The resume phase: both configurations at full width, dropout on, and a
# learning rate (1e-11) that moves the val loss far less than the plateau's
# 1e-6: the plateau lowers the learning rate at epochs 2 and 3 by
# construction, and a run is "crashed" after epoch 1 and again after epoch 2,
# so the restored dropout generator, Adam moments, step count and lowered
# learning rate all reach the resumed run's result.
RESUME_EPOCHS = 3
RESUME_ARGS = {"model.dropout": "0.25", "train.learning_rate": "1e-11",
               "train.lr_plateau_factor": "0.5", "train.lr_plateau_patience": "1"}
# Kernel function names in a torch.profiler trace, by the launch counters
# whose launches they are.
TRACE_KERNELS = {
    "selective_scan": (("selective_scan",), ("selective_scan_kernel",)),
    "selective_scan_bwd": (("selective_scan_bwd",), ("scan_bwd_kernel",)),
    "lstm_gru": (tuple(RNN_KERNELS), ("rnn_reg_kernel", "rnn_cluster_kernel", "rnn_stack_kernel")),
    "lstm_gru_bwd": (tuple(n for n in BWD_KERNELS if n != "selective_scan_bwd"),
                     ("rnn_bwd_reg_kernel", "rnn_bwd_cluster_kernel", "rnn_bwd_cols_kernel")),
}


def _trace_kernel_counts(path) -> dict:
    """Device kernels of a Chrome trace (``torch.profiler``'s) by
    ``TRACE_KERNELS`` group: events of category "kernel" whose name holds
    one of the group's function names."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"]
    return {group: sum(any(k in n for k in kernels) for n in names)
            for group, (_, kernels) in TRACE_KERNELS.items()}


def _nonzero(counts: dict) -> dict:
    return {n: c for n, c in counts.items() if c}


def _counted_groups(launches: dict) -> dict:
    """Launch counters summed by ``TRACE_KERNELS`` group."""
    return {group: sum(launches.get(c, 0) for c in counters)
            for group, (counters, _) in TRACE_KERNELS.items()}


# The torchvision ResNet layouts, written out here independently of the
# porter: (block, blocks a stage), conv weights OIHW.
TORCHVISION_RESNETS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}


def _torchvision_resnet_keys(name: str) -> dict:
    """torchvision's ResNet state_dict layout: key -> shape, ``fc`` included."""
    block, stages = TORCHVISION_RESNETS[name]
    keys = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix, c):
        keys.update({f"{prefix}.weight": (c,), f"{prefix}.bias": (c,),
                     f"{prefix}.running_mean": (c,), f"{prefix}.running_var": (c,),
                     f"{prefix}.num_batches_tracked": ()})

    bn("bn1", 64)
    cin, expansion = 64, (4 if block == "bottleneck" else 1)
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), stages), start=1):
        out = width * expansion
        for b in range(n):
            p = f"layer{stage}.{b}"
            first_in = cin if b == 0 else out
            if block == "bottleneck":
                convs = [(width, first_in, 1), (width, width, 3), (out, width, 1)]
            else:
                convs = [(width, first_in, 3), (width, width, 3)]
            for i, (co, ci, k) in enumerate(convs, start=1):
                keys[f"{p}.conv{i}.weight"] = (co, ci, k, k)
                bn(f"{p}.bn{i}", co)
            if b == 0 and (stage > 1 or cin != out):
                keys[f"{p}.downsample.0.weight"] = (out, cin, 1, 1)
                bn(f"{p}.downsample.1", out)
        cin = out
    keys.update({"fc.weight": (1000, cin), "fc.bias": (1000,)})
    return keys


def _reference_lrcn_keys(model_cfg, seq_len: int) -> dict:
    """The reference LRCN's state_dict layout (``medsos_lrcn/src/models.py:
    121-186``) for ``model_cfg``: key -> shape."""
    keys = {f"cnn_backbone.{k}": s for k, s in _torchvision_resnet_keys(model_cfg.cnn_backbone).items()
            if not k.startswith("fc.")}
    f = keys["cnn_backbone.layer4.0.downsample.0.weight"][0]
    r, h, layers = model_cfg.rnn_input_size, model_cfg.resolved_hidden_size, model_cfg.rnn_layer
    for i, (fin, fout) in enumerate(((f, f // 2), (f // 2, f // 4), (f // 4, r)), start=1):
        keys.update({f"adapt{i}.weight": (fout, fin), f"adapt{i}.bias": (fout,),
                     f"bn{i}.weight": (fout,), f"bn{i}.bias": (fout,)})
    if model_cfg.rnn_type == "mamba":
        d = 2 * r  # d_inner; n_state = dt_rank = hidden
        for i in range(layers):
            m = f"rnn.{i}.mixer"
            keys.update({f"rnn.{i}.norm.weight": (r,), f"{m}.A_log": (d, h), f"{m}.D": (d,),
                         f"{m}.in_proj.weight": (2 * d, r), f"{m}.in_proj.bias": (2 * d,),
                         f"{m}.conv1d.weight": (d, 1, 3), f"{m}.conv1d.bias": (d,),
                         f"{m}.x_proj.weight": (h + 2 * h, d),
                         f"{m}.dt_proj.weight": (d, h), f"{m}.dt_proj.bias": (d,),
                         f"{m}.out_proj.weight": (r, 2 * d if model_cfg.bidirectional else d),
                         f"{m}.out_proj.bias": (r,)})
        width = r
    else:
        gh = (4 if model_cfg.rnn_type == "lstm" else 3) * h
        dirs = ("", "_reverse") if model_cfg.bidirectional else ("",)
        for layer in range(layers):
            fin = r if layer == 0 else h * len(dirs)
            for s in dirs:
                keys.update({f"rnn.weight_ih_l{layer}{s}": (gh, fin),
                             f"rnn.weight_hh_l{layer}{s}": (gh, h),
                             f"rnn.bias_ih_l{layer}{s}": (gh,), f"rnn.bias_hh_l{layer}{s}": (gh,)})
        width = h * len(dirs)
    pooled, c = width * (seq_len if model_cfg.rnn_out == "all" else 1), model_cfg.num_classes
    if model_cfg.classif_mode == "multiclass":
        for name, fin, fout in (("fc", pooled, pooled // 2), ("fca", pooled // 2, pooled // 4),
                                ("fcb", pooled // 4, c)):
            keys.update({f"{name}.weight": (fout, fin), f"{name}.bias": (fout,)})
        for name, n in (("bn0", pooled), ("bna", pooled // 2), ("bnb", pooled // 4)):
            keys.update({f"{name}.weight": (n,), f"{name}.bias": (n,)})
    else:
        for i in range(c):
            keys.update({f"fc.{i}.weight": (1, pooled), f"fc.{i}.bias": (1,)})
    return keys


def _reference_s2vt_keys(backbone: str, cnn_output_size: int, hidden: int, vocab: int) -> dict:
    """The reference VideoAnalysisModel's state_dict layout
    (``s2vt/beam_search.py:229-382``, one GRU layer each side): key ->
    shape. PretrainedCNN registers the torchvision backbone twice: whole
    under ``cnn.model`` and, without its fc, as the ``cnn.feature_extractor``
    Sequential (children conv1, bn1, relu, maxpool, layer1-4, avgpool)."""
    bb = _torchvision_resnet_keys(backbone)
    keys = {f"cnn.model.{k}": s for k, s in bb.items()}
    seq = {"conv1": "0", "bn1": "1", **{f"layer{i}": str(3 + i) for i in range(1, 5)}}
    for k, s in bb.items():
        head, _, rest = k.partition(".")
        if head != "fc":
            keys[f"cnn.feature_extractor.{seq[head]}.{rest}"] = s
    feat, h = bb["fc.weight"][1], hidden
    for name, (fout, fin) in (("cnn.fc", (cnn_output_size, feat)),
                              ("encoder.embedding", (h, cnn_output_size)),
                              ("decoder.attention.attn", (h, h)), ("decoder.out", (vocab, h))):
        keys.update({f"{name}.weight": (fout, fin), f"{name}.bias": (fout,)})
    for side, fin in (("encoder", h), ("decoder", 2 * h)):
        keys.update({f"{side}.gru.weight_ih_l0": (3 * h, fin), f"{side}.gru.weight_hh_l0": (3 * h, h),
                     f"{side}.gru.bias_ih_l0": (3 * h,), f"{side}.gru.bias_hh_l0": (3 * h,)})
    keys["decoder.embedding.weight"] = (vocab, h)
    return keys


def _seeded_state_dict(torch, keys: dict, seed: int) -> dict:
    """Tensors for a key -> shape layout from a numpy seed: weights of two
    or more dimensions N(0, 1/fan_in); norms' and BatchNorms' weights near
    1, running variances in [0.5, 1.5); other vectors N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in keys.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            v = 0.5 + rng.rand(*shape)
        elif len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".weight"):  # norms and BatchNorms
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        out[key] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def _torchvision_to_port(name: str) -> str:
    """A torchvision ResNet key's name in the port's backbone."""
    name = re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", name)
    return name.replace("downsample.0.", "downsample_conv.").replace("downsample.1.", "downsample_bn.")


def _resume_path(torch, gpu, label, model: dict, seq_len: int, tmp: Path) -> dict:
    """``python -m vct_torch.train``'s main at full width: an uninterrupted
    run of RESUME_EPOCHS epochs, then the same run crashed after epoch 1 and
    after epoch 2 and resumed to the end (``train.resume``), its last part
    with ``train.history_path``, ``train.log_every 1`` and
    ``train.profile_dir``. Holds the final parameters, the epoch losses and
    the launches of each resumed epoch equal to the uninterrupted run's, the
    trace's kernels to the launch counters of its epoch; then a fourth
    Trainer warm-starts from the checkpoint (``train.init_from``)."""
    import contextlib
    import io
    import os

    from vct_torch.core.config import Config
    from vct_torch.train import engine
    from vct_torch.train.__main__ import main as train_main
    from vct_torch.train.checkpoint import load_checkpoint

    overrides = {"data.synthetic": "true", "data.synthetic_samples": str(TRAIN_SAMPLES),
                 "data.sequence_length": str(seq_len), "train.batch_size": str(TRAIN_BATCH),
                 "model.compute_dtype": "bfloat16", **RESUME_ARGS,
                 **{f"model.{k}": str(v) for k, v in model.items()}}
    counters = _train_counters()
    epochs, saves = [], []  # launches of each epoch's train loop; (ms, MB) of each save
    real_trace, real_save = engine.device_trace, engine.save_train_state

    @contextlib.contextmanager
    def counted_trace(log_dir, device="cpu"):
        before = {n: fn.launches for n, fn in counters.items()}
        with real_trace(log_dir, device):
            yield
        epochs.append({n: fn.launches - before[n] for n, fn in counters.items()})

    def timed_save(path, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_save(path, *args, **kwargs)
        saves.append(((time.perf_counter() - t0) * 1e3,
                      os.path.getsize(os.path.join(out, "train_state.pt")) / 1e6))
        return out

    def run(n_epochs, path, **extra):
        argv = [a for k, v in {**overrides, "train.epochs": str(n_epochs),
                               "train.model_path": str(path), **extra}.items()
                for a in (f"--{k}", v)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                mock.patch.object(engine, "device_trace", counted_trace), \
                mock.patch.object(engine, "save_train_state", timed_save):
            rc = train_main(argv)
        if rc != 0:
            raise AssertionError(f"{label}: train main rc {rc}")
        return out.getvalue()

    t0 = time.perf_counter()
    out_u = run(RESUME_EPOCHS, tmp / "whole", **{"train.history_path": str(tmp / "whole.json")})
    whole = list(epochs)
    decays = [l for l in out_u.splitlines() if l.startswith("Reducing learning rate")]
    if len(decays) != RESUME_EPOCHS - 1:
        raise AssertionError(f"{label}: the plateau fired {len(decays)} times, not at epochs "
                             f"2..{RESUME_EPOCHS}: {decays}")
    ck = tmp / "resumed"
    epochs.clear()
    run(1, ck, **{"train.resume": "true", "train.save_model": "false"})
    out_2 = run(2, ck, **{"train.resume": "true", "train.save_model": "false"})
    out_3 = run(RESUME_EPOCHS, ck, **{"train.resume": "true", "train.log_every": "1",
                                      "train.history_path": str(tmp / "resumed.json"),
                                      "train.profile_dir": str(tmp / "trace")})
    seconds = time.perf_counter() - t0
    for out, epoch in ((out_2, 1), (out_3, 2)):
        if f"Resuming training from epoch {epoch}" not in out or decays[epoch - 1] not in out:
            raise AssertionError(f"{label}: the run resumed at epoch {epoch} did not resume, "
                                 f"or did not lower the learning rate as the whole run did")
    # (a) the resumed run against the uninterrupted one, bit for bit
    hist_u = json.loads((tmp / "whole.json").read_text())
    hist_r = json.loads((tmp / "resumed.json").read_text())
    for key in ("train_loss", "train_acc", "val_loss"):
        if hist_r[key] != hist_u[key] or len(hist_r[key]) != RESUME_EPOCHS:
            raise AssertionError(f"{label}: resumed {key} {hist_r[key]} != uninterrupted "
                                 f"{hist_u[key]}")
    final_u, final_r = load_checkpoint(str(tmp / "whole"))[0], load_checkpoint(str(ck))[0]
    differ = [k for k in final_u if not torch.equal(final_u[k], final_r[k])]
    if differ or set(final_u) != set(final_r):
        raise AssertionError(f"{label}: resumed parameters differ from the uninterrupted run's "
                             f"at {differ[:8]}")
    if epochs[1:] != whole[1:]:
        raise AssertionError(f"{label}: launches of the resumed epochs {epochs[1:]} != the "
                             f"uninterrupted run's {whole[1:]}")
    # (b) observability of the resumed run
    steps = -(-(TRAIN_SAMPLES - int(round(TRAIN_SAMPLES * 0.2))) // TRAIN_BATCH)
    step_lines = [l for l in out_3.splitlines() if l.startswith("step ")]
    if hist_r["step_times"].get("steps") != steps or len(step_lines) != steps:
        raise AssertionError(f"{label}: {len(step_lines)} step lines and step_times "
                             f"{hist_r['step_times']}, expected {steps} steps")
    traces = sorted((tmp / "trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{label}: train.profile_dir holds {traces}, not one trace")
    in_trace, counted = _trace_kernel_counts(traces[0]), _counted_groups(epochs[-1])
    if in_trace != counted or not any(counted.values()):
        raise AssertionError(f"{label}: kernels in the trace {in_trace} != launch counters of "
                             f"the traced epoch {counted}")
    # (c) a warm start from the resumed run's checkpoint
    cfg = Config().replace(**overrides, **{"train.init_from": str(ck), "train.seed": "7"})
    trainer = engine.Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
    trainer.init_state()
    warm = trainer.model.state_dict()
    differ = [k for k in final_r if not torch.equal(warm[k].cpu(), final_r[k])]
    if differ or set(warm) != set(final_r):
        raise AssertionError(f"{label}: init_from parameters differ from the checkpoint's at "
                             f"{differ[:8]}")
    del trainer, warm
    torch.cuda.empty_cache()
    out = {"config": label, "resume": "bit-equal", "epochs": RESUME_EPOCHS,
           "losses": hist_r["train_loss"], "plateau": decays,
           "launches_per_epoch": [_nonzero(e) for e in whole],
           "resumed_launches": [_nonzero(e) for e in epochs[1:]],
           "trace_kernels": in_trace, "trace_file_mb": traces[0].stat().st_size / 1e6,
           "step_lines": len(step_lines), "init_from": "bit-equal",
           "save_train_state_ms": [s[0] for s in saves],
           "train_state_mb": saves[0][1], "four_runs_s": seconds, "gpu": gpu}
    print(json.dumps(out))
    return out


def _check_backbone_weights(torch, tmp: Path, model: dict, keys: dict, seed: int,
                            to_port) -> int:
    """A seeded torchvision state_dict of the layout ``keys`` through
    ``model.backbone_weights`` into the LRCN of ``model`` (``ModelConfig``
    fields), each tensor checked against the name map ``to_port`` written
    here, the features finite. Returns the number of tensors checked."""
    from vct_torch.core.config import Config
    from vct_torch.train.engine import Trainer

    tv = _seeded_state_dict(torch, keys, seed=seed)
    path = tmp / f"{model['cnn_backbone']}_torchvision.pth"
    torch.save(tv, path)
    cfg = Config().replace(**{"data.sequence_length": str(T), "model.compute_dtype": "bfloat16",
                              "model.backbone_weights": str(path),
                              **{f"model.{k}": str(v) for k, v in model.items()}})
    trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
    trainer.init_state()
    ported = trainer.model.state_dict()
    checked = 0
    for key, value in tv.items():
        if key.startswith(("fc.", "classifier.")) or key.endswith("num_batches_tracked"):
            continue
        if not torch.equal(ported[f"cnn_backbone.{to_port(key)}"].cpu(), value):
            raise AssertionError(f"backbone_weights: {key} was not ported as written")
        checked += 1
    with torch.no_grad():
        clip = torch.rand(2, T, H, W, 3, device=trainer.device)
        feats = trainer.model(clip, features_only=True)
    if feats.shape[:2] != (2, T) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"backbone_weights: features {tuple(feats.shape)} not finite")
    return checked


def _serve_ported(torch, label, argv, tmp: Path, seq_len, mamba_blocks, seed) -> dict:
    """``python -m vct_torch.tools.port_reference`` with ``argv`` on the card
    and on the CPU, ``load_model`` on both, and one 4-video SAD request
    served on the card (launches counted), its frames the CPU's (pixels
    within 1e-6), its logits within 1e-4 (atol = rtol, TF32 off) and its
    labels equal."""
    from vct_torch.device import resolve_device
    from vct_torch.serve.deployment import load_model, sample_decoded_clips
    from vct_torch.tools.port_reference import main as port_main

    names = argv[argv.index("--classes") + 1].split(",")
    t0 = time.perf_counter()
    if port_main(argv + ["--out", str(tmp / "card")]) != 0:
        raise AssertionError(f"{label}: port_reference failed on the card")
    port_s = time.perf_counter() - t0
    if port_main(argv + ["--out", str(tmp / "cpu"), "--device", "cpu"]) != 0:
        raise AssertionError(f"{label}: port_reference failed on the CPU")
    model, class_names, _ = load_model(str(tmp / "card"))
    model_cpu, _, _ = load_model(str(tmp / "cpu"), device="cpu")
    if class_names != names or next(model.parameters()).device.type != resolve_device().type:
        raise AssertionError(f"{label}: {class_names} on {next(model.parameters()).device}")
    launches = _serve_counted(torch, label, model, class_names, seq_len, ("sad",), seed,
                              mamba_blocks)
    # The same frames on both (the SAD scores are exact, ties break to the
    # lower index); the card's /255 multiplies by the reciprocal, so a pixel
    # may differ by its last bit, while another frame would differ by 1/255.
    videos = _synthetic_videos(SERVED_LENGTHS[:4], seed=seed)  # the served request's
    clips = sample_decoded_clips(videos, "sad", seq_len)
    clips_cpu = sample_decoded_clips(videos, "sad", seq_len, device="cpu")
    frame_err = (clips.cpu() - clips_cpu).abs().max().item()
    if frame_err > 1e-6:
        raise AssertionError(f"{label}: card and CPU selected different frames (largest pixel "
                             f"difference {frame_err})")
    with torch.inference_mode():
        logits = model(clips).cpu()
        logits_cpu = model_cpu(clips_cpu)
    torch.testing.assert_close(logits, logits_cpu, atol=1e-4, rtol=1e-4)
    labels = [class_names[i] for i in logits.argmax(dim=-1).tolist()]
    labels_cpu = [class_names[i] for i in logits_cpu.argmax(dim=-1).tolist()]
    if labels != labels_cpu:
        raise AssertionError(f"{label}: labels {labels} != the CPU's {labels_cpu}")
    del model, model_cpu
    torch.cuda.empty_cache()
    return {"port_reference_s": port_s, "launches": _nonzero(launches),
            "frames_max_abs_err": frame_err,
            "logits_max_abs_err": (logits - logits_cpu).abs().max().item(), "labels": labels}


def _weights_path(torch, gpu, tmp: Path) -> dict:
    """A seeded torchvision ResNet state_dict through ``model.backbone_weights``
    into the deployed model, each tensor checked against the key map written
    here; a seeded reference-LRCN state_dict of the deployed config through
    ``python -m vct_torch.tools.port_reference`` on the card and on the CPU,
    ``load_model`` on both, and one 4-video SAD request served on the card
    (``_serve_ported``)."""
    from vct_torch.core.config import ModelConfig

    model_cfg = ModelConfig(**DEPLOYED)
    checked = _check_backbone_weights(torch, tmp, DEPLOYED,
                                      _torchvision_resnet_keys(model_cfg.cnn_backbone), 11,
                                      _torchvision_to_port)
    torch.save(_seeded_state_dict(torch, _reference_lrcn_keys(model_cfg, T), seed=12),
               tmp / "reference_lrcn.pth")
    argv = ["--state_dict", str(tmp / "reference_lrcn.pth"), "--num_classes",
            str(model_cfg.num_classes), "--sequence_length", str(T), "--cnn_backbone",
            model_cfg.cnn_backbone, "--rnn_type", model_cfg.rnn_type, "--rnn_input_size",
            str(model_cfg.rnn_input_size), "--rnn_layer", str(model_cfg.rnn_layer),
            "--scan_impl", model_cfg.scan_impl, "--classes",
            ",".join(f"label_{i}" for i in range(model_cfg.num_classes))]
    (tmp / "lrcn").mkdir()
    out = {"config": "deployed_mamba", "backbone_weights": f"{checked} tensors ported as written",
           **_serve_ported(torch, "load_model request", argv, tmp / "lrcn", T,
                           model_cfg.rnn_layer, seed=13), "gpu": gpu}
    print(json.dumps(out))
    return out


def _resume_and_weights(torch, gpu) -> None:
    """Resume, observability and the warm start for both configurations,
    then the weight import and ``load_model``'s served request."""
    import tempfile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, (model, seq_len) in TRAIN_CONFIGS.items():
            (Path(tmp) / label).mkdir()
            _resume_path(torch, gpu, label, model, seq_len, Path(tmp) / label)
        _weights_path(torch, gpu, Path(tmp))
    print(f"resume and weights phase: {time.perf_counter() - t0:.1f} s")


# The zoo phase: VideoMamba at vct's full width (resnet50 in bf16, 4 blocks,
# d_model 512, d_inner 2048, n_state 16, dt_rank 16, temporal mean) at T=16;
# the deployed LRCN (3 Mamba blocks, rnn_input 8, T=60) on each other
# backbone, the sweep winner's mobilenet_v2 first; the scratch CNN families;
# the importers of a torchvision mobilenet_v2 and a reference VideoMamba.
T_VM = 16
VIDEOMAMBA = dict(model_family="videomamba", cnn_backbone="resnet50", scan_impl="pallas")
ZOO_BACKBONES = ("mobilenet_v2", "efficientnet_b0", "densenet121", "vgg16", "alexnet",
                 "inception_v3")
SCRATCH_FAMILIES = ("lrcn2", "td_cnn_lstm")


# The torchvision mobilenet_v2 layout, written out here independently of the
# porter: (expand_ratio, channels, blocks, first stride) a stage, channels
# rounded to multiples of 8, conv weights OIHW (depthwise (C, 1, 3, 3)).
TORCHVISION_MOBILENET_V2 = [(1, 16, 1), (6, 24, 2), (6, 32, 3), (6, 64, 4), (6, 96, 3),
                            (6, 160, 3), (6, 320, 1)]


def _torchvision_mobilenet_v2_keys() -> dict:
    """torchvision's mobilenet_v2 state_dict layout: key -> shape, the
    classifier included."""
    keys = {}

    def bn(prefix, c):
        keys.update({f"{prefix}.weight": (c,), f"{prefix}.bias": (c,),
                     f"{prefix}.running_mean": (c,), f"{prefix}.running_var": (c,),
                     f"{prefix}.num_batches_tracked": ()})

    keys["features.0.0.weight"] = (32, 3, 3, 3)
    bn("features.0.1", 32)
    cin, f = 32, 1
    for t, c, n in TORCHVISION_MOBILENET_V2:
        for _ in range(n):
            p, hidden, j = f"features.{f}.conv", cin * t, 0
            if t != 1:
                keys[f"{p}.0.0.weight"] = (hidden, cin, 1, 1)
                bn(f"{p}.0.1", hidden)
                j = 1
            keys[f"{p}.{j}.0.weight"] = (hidden, 1, 3, 3)
            bn(f"{p}.{j}.1", hidden)
            keys[f"{p}.{j + 1}.weight"] = (c, hidden, 1, 1)
            bn(f"{p}.{j + 2}", c)
            cin, f = c, f + 1
    keys["features.18.0.weight"] = (1280, 320, 1, 1)
    bn("features.18.1", 1280)
    keys.update({"classifier.1.weight": (1000, 1280), "classifier.1.bias": (1000,)})
    return keys


def _mobilenet_v2_to_port(name: str) -> str:
    """A torchvision mobilenet_v2 key's name in the port's backbone: stem and
    head pairs; in block i-1 of ``features.i.conv``, a (conv, BN) pair j is
    ``conv{j}``, and the bare projection conv and the BN after it (indices
    n-1 and n, n = 2 in ``features.1``, the block without an expansion, and
    3 elsewhere) the last ``conv{n-1}``'s."""
    m = re.fullmatch(r"features\.(0|18)\.([01])\.(.+)", name)
    if m:
        return f"{'stem' if m[1] == '0' else 'head'}.{'conv' if m[2] == '0' else 'bn'}.{m[3]}"
    m = re.fullmatch(r"features\.(\d+)\.conv\.(\d+)\.([01])\.(.+)", name)
    if m:
        return f"block{int(m[1]) - 1}.conv{m[2]}.{'conv' if m[3] == '0' else 'bn'}.{m[4]}"
    block, j, leaf = re.fullmatch(r"features\.(\d+)\.conv\.(\d+)\.(.+)", name).groups()
    n = 2 if block == "1" else 3
    return f"block{int(block) - 1}.conv{n - 1}.{'conv' if int(j) == n - 1 else 'bn'}.{leaf}"


def _reference_videomamba_keys(model_cfg) -> dict:
    """The reference VideoMamba's state_dict layout (``lrcn/videomamba.py:
    332-386``) for ``model_cfg``: key -> shape; multiclass, temporal mean."""
    keys = {f"cnn_backbone.{k}": s for k, s in _torchvision_resnet_keys(model_cfg.cnn_backbone).items()
            if not k.startswith("fc.")}
    f = keys["cnn_backbone.layer4.0.downsample.0.weight"][0]
    d, di = model_cfg.vm_d_model, model_cfg.vm_d_inner
    n, r = model_cfg.vm_n_state, model_cfg.vm_dt_rank
    keys.update({"adapt.weight": (d, f), "adapt.bias": (d,), "norm_f.weight": (d,),
                 "classifier.weight": (model_cfg.num_classes, d),
                 "classifier.bias": (model_cfg.num_classes,)})
    for i in range(model_cfg.vm_n_layer):
        m = f"layers.{i}.mixer"
        keys.update({f"layers.{i}.norm.weight": (d,), f"{m}.A_log": (di, n), f"{m}.D": (di,),
                     f"{m}.in_proj.weight": (2 * di, d), f"{m}.in_proj.bias": (2 * di,),
                     f"{m}.conv1d.weight": (di, 1, 3), f"{m}.conv1d.bias": (di,),
                     f"{m}.x_proj.weight": (r + 2 * n, di), f"{m}.dt_proj.weight": (di, r),
                     f"{m}.dt_proj.bias": (di,), f"{m}.out_proj.weight": (d, di),
                     f"{m}.out_proj.bias": (d,)})
    return keys


def _zoo_weights(torch, gpu, tmp: Path) -> dict:
    """A seeded torchvision mobilenet_v2 state_dict through
    ``model.backbone_weights`` into the deployed LRCN on mobilenet_v2, each
    tensor checked against the name map written here; a seeded reference
    VideoMamba state_dict through ``python -m vct_torch.tools.port_reference
    --model_family videomamba`` on the card and on the CPU, ``load_model``
    on both, and one 4-video SAD request served on the card
    (``_serve_ported``)."""
    from vct_torch.core.config import ModelConfig

    checked = _check_backbone_weights(torch, tmp, {**DEPLOYED, "cnn_backbone": "mobilenet_v2"},
                                      _torchvision_mobilenet_v2_keys(), 21,
                                      _mobilenet_v2_to_port)
    model_cfg = ModelConfig(**VIDEOMAMBA)
    torch.save(_seeded_state_dict(torch, _reference_videomamba_keys(model_cfg), seed=22),
               tmp / "reference_videomamba.pth")
    argv = ["--state_dict", str(tmp / "reference_videomamba.pth"), "--model_family",
            "videomamba", "--num_classes", str(model_cfg.num_classes), "--sequence_length",
            str(T_VM), "--cnn_backbone", model_cfg.cnn_backbone, "--scan_impl",
            model_cfg.scan_impl, "--classes",
            ",".join(f"label_{i}" for i in range(model_cfg.num_classes))]
    argv += [a for k in ("vm_d_model", "vm_d_inner", "vm_n_state", "vm_dt_rank", "vm_n_layer")
             for a in (f"--{k}", str(getattr(model_cfg, k)))]
    (tmp / "videomamba").mkdir()
    out = {"config": "videomamba",
           "backbone_weights": f"mobilenet_v2, {checked} tensors ported as written",
           **_serve_ported(torch, "ported reference VideoMamba", argv, tmp / "videomamba", T_VM,
                           model_cfg.vm_n_layer, seed=23), "gpu": gpu}
    print(json.dumps(out))
    return out


def _zoo_path(torch, gen, gpu) -> dict:
    """VideoMamba at full width served (three 4-video SAD requests, launches
    counted), its bench-shaped step timed and held (kernel vs plain, card vs
    CPU), trained through ``main`` (launches counted), 5 Adam steps held
    kernel vs plain and its train step timed; the deployed LRCN on each
    other backbone served once and its bench-shaped step timed and held; the
    scratch CNN families served once each; the zoo's importers. Returns the
    VideoMamba path's launches: its served requests' and its train run's."""
    import tempfile

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    summary = {}
    vm_cfg = ModelConfig(**VIDEOMAMBA)
    classes = [f"class_{i}" for i in range(vm_cfg.num_classes)]
    model = build_model(ModelConfig(**VIDEOMAMBA, compute_dtype="bfloat16"), T_VM, seed=0)
    served = _serve_counted(torch, "videomamba", model, classes, T_VM, ("sad",) * 3, seed=31,
                            mamba_blocks=vm_cfg.vm_n_layer)
    summary["videomamba_clips_per_s"] = _bench_and_hold(
        torch, model, vm_cfg, T_VM, gpu, "videomamba", seed=32)["serving_clips_per_s"]
    del model
    torch.cuda.empty_cache()
    trained = _train_cli(torch, "videomamba", VIDEOMAMBA, T_VM)
    summary["videomamba_train_step_ms"] = _train_hold_and_time(
        torch, gen, gpu, "videomamba", VIDEOMAMBA, T_VM)["train_step_ms"]
    for i, backbone in enumerate(ZOO_BACKBONES):
        cfg32 = ModelConfig(**{**DEPLOYED, "cnn_backbone": backbone})
        model = build_model(ModelConfig(**{**DEPLOYED, "cnn_backbone": backbone,
                                           "compute_dtype": "bfloat16"}), T, seed=0)
        label = f"lrcn_{backbone}"
        _serve_counted(torch, label, model, classes, T, ("sad",), seed=40 + i,
                       mamba_blocks=cfg32.rnn_layer)
        summary[f"{label}_clips_per_s"] = _bench_and_hold(
            torch, model, cfg32, T, gpu, label, seed=50 + i)["serving_clips_per_s"]
        del model
        torch.cuda.empty_cache()
    for i, family in enumerate(SCRATCH_FAMILIES):
        model = build_model(ModelConfig(model_family=family), T, seed=0, frame_size=(H, W))
        _serve_counted(torch, family, model, classes, T, ("sad",), seed=60 + i, mamba_blocks=0)
        del model
    with tempfile.TemporaryDirectory() as tmp:
        _zoo_weights(torch, gpu, Path(tmp))
    summary["gpu"] = gpu
    print(json.dumps(summary))
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s")
    return {"served": served, "trained": trained}


# The captioning phase: the five captioners of vct's CaptionConfig at full
# width (vct/core/config.py:264-297: resnet50 in f32, cnn_output_size and
# hidden_size 512, 30 frames, captions of 30 tokens, beam 3; the 1s2vt's 4
# GRU layers, the transformer's 8 heads and 2 layers, the v1 decoders' 3
# layers and 8 heads) on 224x224 frames, with seeded weights and a seeded
# vocabulary of CAPTION_VOCAB words standing in for one built from an
# annotation file (none is in the repo). No kernel is on this path, in vct
# or in the port: every launch counter must read 0 around it.
CAPTION_KINDS = {"s2vt": {}, "1s2vt": {"encoder_layers": 4},
                 "transformer": {"model_kind": "transformer"},
                 "v1_lstm": {"model_kind": "v1_lstm"}, "v1_gru": {"model_kind": "v1_gru"}}
CAPTION_VOCAB = 10_000
# B=8 is vct's checkpoint chunk (vct/caption/infer.py:192); 30x224x224 its clips.
CAPTION_CLIPS, CAPTION_T, CAPTION_HW = 8, 30, 224
# Clips the CPU holds the card to: 2 of the 8. On all 8 the CPU's share of
# the phase took 145 s on the card's host (29 s a captioner: three f32
# resnet50 passes over 240 frames of 224x224), past the phase's 60 s.
CAPTION_CPU_CLIPS = 2
# The CLI's batch (vct/caption/__main__.py:100) for the timed train step.
CAPTION_TRAIN_BATCH = 4
CAPTION_TOL = 1e-4


def _all_counters():
    """Every kernel wrapper's launch counter, serving's and training's."""
    return {**_serve_counters(), **_train_counters()}


def _require_no_launches(label: str, counters: dict) -> None:
    """Fail unless every counter reads 0: captioning reaches no kernel."""
    launched = _nonzero({n: fn.launches for n, fn in counters.items()})
    if launched:
        raise AssertionError(f"{label}: kernels launched on a path that reaches none: {launched}")


def _caption_vocab():
    """The stand-in vocabulary: the four specials and CAPTION_VOCAB - 4 words."""
    from vct_torch.caption.vocab import Vocabulary

    vocab = Vocabulary()
    for i in range(CAPTION_VOCAB - 4):
        vocab.add_word(f"w{i}")
    return vocab


def _caption_cfg(kind: str, **extra):
    from vct_torch.core.config import CaptionConfig

    return CaptionConfig(**{**CAPTION_KINDS[kind], **extra})


def _seeded_captions(torch, gen, n: int, length: int):
    """Token rows as ``encode_caption`` lays them out: <start>, 5 (fewer
    in a short row) to length - 2 words, <end>, <pad> to the end."""
    rows = torch.zeros(n, length, dtype=torch.long)
    for r in range(n):
        k = int(torch.randint(min(5, length - 2), length - 1, (1,), generator=gen))
        rows[r, 0], rows[r, k + 1] = 1, 2
        rows[r, 1 : k + 1] = torch.randint(4, CAPTION_VOCAB, (k,), generator=gen)
    return rows


def _sequence_scores(torch, model, video, seqs, stops):
    """The model's teacher-forced log-prob of each row of ``seqs`` (B, L)
    summed through position ``stops[b]``: a beam's score of that sequence
    when ``stops`` is its first <end> (a greedy step's rank of its prefix
    when ``stops`` is the first position two sequences part)."""
    with torch.no_grad():
        logp = model.eval()(video, seqs)
    tok = logp.gather(-1, seqs[..., None])[..., 0]
    keep = torch.arange(seqs.shape[1])[None, :] <= stops[:, None]
    return (tok * keep).sum(dim=1)


def _first_end(torch, seqs, end: int = 2):
    """Each row's first <end> position (its last where it has none)."""
    is_end = seqs == end
    last = torch.full((seqs.shape[0],), seqs.shape[1] - 1, dtype=torch.long)
    return torch.where(is_end.any(dim=1), is_end.to(torch.long).argmax(dim=1), last)


def _hold_tokens(label: str, card, cpu, scores, tol: float = CAPTION_TOL) -> int:
    """Card and CPU token rows must be equal. The one allowed exception is a
    tie: a row whose two sequences the CPU scores within ``tol`` of each
    other (``scores()``, called only if a row differs: the CPU's scores of
    the card's rows and of its own); both sequences are printed. Returns
    the ties."""
    differ = [b for b in range(cpu.shape[0]) if not bool((card[b] == cpu[b]).all())]
    if not differ:
        return 0
    card_scores, cpu_scores = scores()
    for b in differ:
        gap = abs(float(card_scores[b]) - float(cpu_scores[b]))
        if gap > tol:
            raise AssertionError(f"{label}: row {b} card {card[b].tolist()} != CPU "
                                 f"{cpu[b].tolist()} (CPU scores {float(card_scores[b])} vs "
                                 f"{float(cpu_scores[b])}, gap {gap} > {tol})")
        print(f"{label}: row {b} ties within {tol} on the CPU (gap {gap}): card "
              f"{card[b].tolist()} / CPU {cpu[b].tolist()}")
    return len(differ)


def _caption_serve(torch, gen, gpu, kind: str, videos) -> dict:
    """One captioner at full width on the card: beam (K=3) and greedy
    captions of CAPTION_CLIPS clips and the teacher-forced log-probs,
    launches read around exactly that run (all 0); the card held against
    an f32 copy on the CPU (TF32 off) on the first CAPTION_CPU_CLIPS clips;
    beam captioning timed as clips/s, the backbone alone beside it."""
    from vct_torch.caption.beam import beam_search, greedy_decode
    from vct_torch.caption.models import frames_of
    from vct_torch.caption.train import build_captioner

    cfg = _caption_cfg(kind)
    model = build_captioner(cfg, CAPTION_VOCAB, seed=0)
    targets = _seeded_captions(torch, gen, CAPTION_CLIPS, cfg.max_caption_len).cuda()
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    beam_t, beam_s = beam_search(model, videos, cfg.beam_width, cfg.max_caption_len)
    greedy = greedy_decode(model, videos, cfg.max_caption_len)
    with torch.no_grad():
        logp = model(videos, targets)
    torch.cuda.synchronize()
    _require_no_launches(f"caption {kind}", counters)

    n = CAPTION_CPU_CLIPS
    t0 = time.perf_counter()
    cpu_model = build_captioner(cfg, CAPTION_VOCAB, device="cpu", seed=0)
    v_cpu, t_cpu = videos[:n].cpu(), targets[:n].cpu()
    with torch.no_grad():
        logp_cpu = cpu_model(v_cpu, t_cpu)
    err = (logp[:n].cpu() - logp_cpu).abs().max().item()
    torch.testing.assert_close(logp[:n].cpu(), logp_cpu, atol=CAPTION_TOL, rtol=CAPTION_TOL)
    cpu_t, cpu_s = beam_search(cpu_model, v_cpu, cfg.beam_width, cfg.max_caption_len)
    card_t = beam_t[:n].cpu()
    seq_card, seq_cpu = card_t[:, 1:], cpu_t[:, 1:]
    ties = _hold_tokens(f"caption {kind} beam", card_t, cpu_t, lambda: (
        _sequence_scores(torch, cpu_model, v_cpu, seq_card, _first_end(torch, seq_card)),
        _sequence_scores(torch, cpu_model, v_cpu, seq_cpu, _first_end(torch, seq_cpu))))
    same = (card_t == cpu_t).all(dim=1)
    score_err = (beam_s[:n].cpu() - cpu_s)[same].abs().max().item() if bool(same.any()) else 0.0
    if score_err > CAPTION_TOL * max(1.0, cpu_s.abs().max().item()):
        raise AssertionError(f"caption {kind}: beam scores card vs CPU err {score_err}")
    cpu_g = greedy_decode(cpu_model, v_cpu, cfg.max_caption_len)
    card_g = greedy[:n].cpu()
    parted = (card_g != cpu_g).to(torch.long).argmax(dim=1)  # the first position they part
    ties += _hold_tokens(f"caption {kind} greedy", card_g, cpu_g, lambda: (
        _sequence_scores(torch, cpu_model, v_cpu, card_g, parted),
        _sequence_scores(torch, cpu_model, v_cpu, cpu_g, parted)))
    cpu_s_elapsed = time.perf_counter() - t0
    del cpu_model

    beam_ms = _events_ms(torch, lambda: beam_search(model, videos, cfg.beam_width,
                                                    cfg.max_caption_len), iters=3, warmup=1)
    greedy_ms = _events_ms(torch, lambda: greedy_decode(model, videos, cfg.max_caption_len),
                           iters=3, warmup=1)
    with torch.no_grad():
        backbone_ms = _events_ms(torch, lambda: model.cnn(frames_of(videos), features_only=True),
                                 iters=3, warmup=1)
    out = {"caption": kind, f"caption_{kind}_clips_per_s": CAPTION_CLIPS * 1e3 / beam_ms,
           "clips": CAPTION_CLIPS, "beam_ms": beam_ms, "backbone_ms": backbone_ms,
           "decode_ms": beam_ms - backbone_ms, "greedy_ms": greedy_ms,
           "logp_max_abs_err_vs_cpu": err, "beam_score_max_abs_err_vs_cpu": score_err,
           "cpu_held_clips": n, "ties": ties, "cpu_s": cpu_s_elapsed,
           "launches": 0, "gpu": gpu}
    print(json.dumps(out), flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def _caption_cli(torch, kind: str, tmp: Path) -> float:
    """``python -m vct_torch.caption --synthetic`` (``main``, 2 epochs) at
    full width on the card, launches read around it (all 0); returns the
    BLEU of its 'Average BLEU score:' line."""
    import contextlib
    import io

    from vct_torch.caption.__main__ import main

    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--synthetic", "--epochs", "2", "--model_kind", CAPTION_KINDS[kind].get(
            "model_kind", "s2vt"), "--checkpoint_dir", str(tmp / f"cli_{kind}")])
    torch.cuda.synchronize()
    out = buf.getvalue()
    lines = [l for l in out.splitlines() if l.startswith("Average BLEU score:")]
    epochs = [l for l in out.splitlines() if l.startswith("Epoch [")]
    if rc != 0 or len(lines) != 1 or len(epochs) != 2 or "inference_duration:" not in out:
        raise AssertionError(f"caption CLI ({kind}) rc {rc}, output:\n{out}")
    _require_no_launches(f"caption CLI {kind}", counters)
    bleu = float(lines[0].split(":")[1])
    print(f"caption CLI ({kind}): {epochs[-1]}; {lines[0]}")
    return bleu


def _caption_train(torch, gen, gpu, tmp: Path) -> dict:
    """The S2VT train step at the CLI's batch on 30x224x224 clips, timed
    with and without the feature cache; 5 Adam steps card against CPU on
    the card's backbone features (dropout 0); a run resumed after epoch 1
    bit-equal to the uninterrupted one (dropout on); a seeded reference
    S2VT state_dict through ``port_reference_s2vt`` on the card and on the
    CPU."""
    from vct_torch.caption.train import CaptionTrainer, build_captioner
    from vct_torch.models.lrcn_port import port_reference_s2vt

    vocab = _caption_vocab()
    cfg = _caption_cfg("s2vt", dropout=0.0)
    B = CAPTION_TRAIN_BATCH
    clips = torch.rand(B, CAPTION_T, CAPTION_HW, CAPTION_HW, 3, generator=gen).cuda()
    caps = [_seeded_captions(torch, gen, B, cfg.max_caption_len).cuda() for _ in range(5)]
    mask = torch.ones(B, device=clips.device)
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    trainer = CaptionTrainer(cfg, vocab)
    state = trainer.init_state()
    step_ms = _events_ms(torch, lambda: trainer._train_step(state, clips, caps[0], mask),
                         iters=5, warmup=2)
    with torch.no_grad():
        feats = trainer.model.extract_features(clips)
    trainer._feature_mode = True
    feat_step_ms = _events_ms(torch, lambda: trainer._train_step(state, feats, caps[0], mask),
                              iters=10, warmup=2)
    del trainer, state

    # 5 Adam steps, card against CPU, from the same seeded weights and features.
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = CaptionTrainer(cfg, vocab, device=dev)
        trainer._feature_mode = True
        state = trainer.init_state()
        x = feats.to(dev)
        losses = [trainer._train_step(state, x, c.to(dev), mask.to(dev))[0].item() for c in caps]
        runs[dev] = (losses, {n: p.detach().cpu() for n, p in trainer.model.named_parameters()
                              if p.requires_grad})
        del trainer, state
    (l_card, p_card), (l_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    param_err = max(((p_card[n] - p_cpu[n]).norm() / p_cpu[n].norm()).item() for n in p_cpu)
    if not (loss_err <= CAPTION_TOL and param_err <= CAPTION_TOL):
        raise AssertionError(f"caption 5 Adam steps card vs CPU: losses rel err {loss_err}, "
                             f"parameters rel err {param_err}, over {CAPTION_TOL}")

    # Resume: a run crashed after epoch 1 continues bit for bit.
    rcfg = _caption_cfg("s2vt")  # dropout 0.1, vct's default
    rng = np.random.RandomState(7)
    x = rng.rand(8, CAPTION_T, 64, 64, 3).astype(np.float32)
    y = _seeded_captions(torch, gen, 8, rcfg.max_caption_len).numpy()
    straight = CaptionTrainer(dataclasses.replace(rcfg, epochs=2), vocab, seed=3)
    s1, want = straight.fit(straight.init_state(), x, y, checkpoint_dir=str(tmp / "a"), log=False)
    first = CaptionTrainer(dataclasses.replace(rcfg, epochs=1), vocab, seed=3)
    first.fit(first.init_state(), x, y, checkpoint_dir=str(tmp / "b"), log=False)
    again = CaptionTrainer(dataclasses.replace(rcfg, epochs=2), vocab, seed=5)
    s2, got = again.fit(again.init_state(), x, y, checkpoint_dir=str(tmp / "b"), log=False)
    unequal = [n for (n, a), (_, b) in zip(s1.model.state_dict().items(),
                                            s2.model.state_dict().items()) if not torch.equal(a, b)]
    if got != want or unequal or s1.step != s2.step:
        raise AssertionError(f"caption resume: losses {got} vs {want}, unequal tensors "
                             f"{unequal[:4]}, steps {s2.step} vs {s1.step}")
    del straight, first, again, s1, s2

    # The reference S2VT importer, on the card and on the CPU.
    full = _caption_cfg("s2vt")
    sd = _seeded_state_dict(torch, _reference_s2vt_keys(full.cnn_backbone, full.cnn_output_size,
                                                        full.hidden_size, CAPTION_VOCAB), seed=21)
    v = clips[:2]
    t = caps[0][:2]
    logps = {}
    for dev in ("cuda", "cpu"):
        m = port_reference_s2vt(build_captioner(full, CAPTION_VOCAB, device=dev), sd)
        with torch.no_grad():
            logps[dev] = m(v.to(dev), t.to(dev)).cpu()
        del m
    torch.cuda.synchronize()
    _require_no_launches("caption training, resume and import", counters)
    import_err = (logps["cuda"] - logps["cpu"]).abs().max().item()
    torch.testing.assert_close(logps["cuda"], logps["cpu"], atol=CAPTION_TOL, rtol=CAPTION_TOL)
    out = {"caption_train_step_ms": {"raw": step_ms, "feature_cache": feat_step_ms},
           "batch": B, "T": CAPTION_T, "frame": CAPTION_HW,
           "adam_5_steps_card_vs_cpu": {"losses": l_card, "loss_rel_err": loss_err,
                                        "param_rel_err": param_err},
           "resume_bit_equal": True, "resume_losses": got,
           "port_reference_s2vt_logp_max_abs_err_card_vs_cpu": import_err, "gpu": gpu}
    print(json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def _caption_path(torch, gen, gpu) -> None:
    """Phase 14: the five captioners served (``_caption_serve``), the CLI
    for S2VT and the transformer, the S2VT train step, its card-vs-CPU
    Adam steps, resume and the reference importer (``_caption_train``)."""
    import tempfile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    videos = torch.rand(CAPTION_CLIPS, CAPTION_T, CAPTION_HW, CAPTION_HW, 3, generator=gen).cuda()
    served = {kind: _caption_serve(torch, gen, gpu, kind, videos) for kind in CAPTION_KINDS}
    del videos
    cpu_s = sum(s["cpu_s"] for s in served.values())
    with tempfile.TemporaryDirectory() as tmp:
        bleu = {kind: _caption_cli(torch, kind, Path(tmp)) for kind in ("s2vt", "transformer")}
        train = _caption_train(torch, gen, gpu, Path(tmp))
    summary = {**{f"caption_{k}_clips_per_s": s[f"caption_{k}_clips_per_s"]
                  for k, s in served.items()},
               "caption_train_step_ms": train["caption_train_step_ms"], "cli_bleu": bleu,
               "cpu_hold_s": cpu_s, "cpu_held_clips": CAPTION_CPU_CLIPS, "gpu": gpu}
    print(json.dumps(summary))
    print(f"caption phase: {time.perf_counter() - t0:.1f} s (the CPU's holds {cpu_s:.1f} s, "
          f"on {CAPTION_CPU_CLIPS} of {CAPTION_CLIPS} clips)")


# The files phase: the deployed LRCN (DEPLOYED, resnet50 in bf16, T=60,
# 80x80) trained from a directory of video files and classifying one. The
# seeded videos are written as uncompressed BGR24 AVI files (standard library
# only), which every ffmpeg-based reader decodes to the exact pixels.
FILES_CLIPS, FILES_RAW, FILES_CLASSES = 64, 120, 2
FILES_BATCH = 32
# Decoded lengths of the served videos: a short one (cycled up to T) and
# others bucketed and selected on the device.
FILES_SERVED = [50, 61, 90, 120, 75, 100, 64, 120]
# The CLI against classify_videos in process on the same clips.
FILES_TOL = 1e-5
FILES_TIMED_EPOCHS = 3
FFMPEG_LIBS = ("avcodec", "avformat", "swscale")
FFMPEG_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h")
INCLUDE_DIRS = ("/usr/include", "/usr/include/x86_64-linux-gnu", "/usr/local/include")


def _write_avi(path: Path, frames_rgb: np.ndarray, fps: int = 25) -> None:
    """(n, H, W, 3) uint8 RGB frames as an uncompressed BGR24 AVI file:
    RIFF 'AVI ' with one video stream of top-down DIB frames (a negative
    height; '00db' chunks, rows padded to 4 bytes) and an idx1 index.
    Top-down, because cv2 5.0's FFmpeg reader crashed on the bottom-up
    layout (a positive height) that the system's libavformat reads."""
    import struct

    n, h, w, _ = frames_rgb.shape
    row = (3 * w + 3) & ~3
    size = row * h
    frames = np.zeros((n, h, row), np.uint8)
    frames[:, :, :3 * w] = frames_rgb[..., ::-1].reshape(n, h, 3 * w)

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def lst(kind: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", kind + data)

    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, 0x10, n, 0, 1, size, w, h,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n, size,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = b"".join(chunk(b"00db", f.tobytes()) for f in frames)
    idx1 = b"".join(struct.pack("<4sIII", b"00db", 0x10, 4 + i * (8 + size), size)
                    for i in range(n))
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", idx1)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _host_decoders() -> dict:
    """What this host can decode with: cv2 and h5py (imported), the ffmpeg
    libraries (``ldconfig -p``) and headers, and the native decoder
    (``vct_torch.data.videodec.is_available()``), printed on one line."""
    import importlib

    from vct_torch.data import videodec

    found = {}
    for name in ("cv2", "h5py"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = None
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    found["ldconfig"] = {lib: f"lib{lib}." in ldconfig for lib in FFMPEG_LIBS}
    found["headers"] = {hdr: any(Path(d, hdr).is_file() for d in INCLUDE_DIRS)
                        for hdr in FFMPEG_HEADERS}
    found["native_decoder"] = videodec.is_available()
    yes = lambda v: "yes" if v else "no"  # noqa: E731
    print(f"host: cv2 {found['cv2'] or 'no'}; h5py {found['h5py'] or 'no'}; ldconfig "
          + ", ".join(f"lib{k} {yes(v)}" for k, v in found["ldconfig"].items()) + "; headers "
          + ", ".join(f"{k} {yes(v)}" for k, v in found["headers"].items())
          + f"; native decoder (vct_torch/native/videodec.cpp) "
          + ("builds" if found["native_decoder"] else "unavailable"), flush=True)
    return found


def _cli_results(text: str) -> list:
    """The JSON list ``classify_and_display`` prints."""
    lines = text.splitlines()
    start = lines.index("[")
    return json.loads("\n".join(lines[start:lines.index("]", start) + 1]))


def _hold_cli_probs(label: str, results: list, names: list, class_names: list,
                    want: np.ndarray) -> float:
    """The CLI's probabilities (sorted per video with their labels) against
    ``want`` (N, classes) in class order; returns the largest difference."""
    _check_served(results, names)
    got = np.zeros_like(want)
    for i, r in enumerate(results):
        for lab, score in zip(r["labels"], r["scores"]):
            got[i, class_names.index(lab)] = score
    err = float(np.abs(got - want).max())
    if not err <= FILES_TOL:
        raise AssertionError(f"{label}: CLI probabilities differ from classify_videos by {err}")
    return err


class _Backend:
    """A local HTTP server that records the JSON bodies POSTed to it and
    answers 200."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies = []
        bodies = self.bodies

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/classify"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def _timed_loader(loader, waits: list):
    """``loader`` whose epochs record, in ``waits``, the host seconds each
    batch took to come out of it."""
    epoch = loader.epoch

    def timed(rng=None):
        it = epoch(rng)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield batch

    loader.epoch = timed
    return loader


def _files_ingest(root: Path, found: dict) -> tuple:
    """Write the seeded dataset and served videos as AVI files, hold the
    decode against the seeded frames and build the clip cache. Returns
    (the train CLI's argv, its Config, the served videos, decode ms a video
    (None where nothing decodes), the cache's build seconds)."""
    from vct_torch.core.config import Config
    from vct_torch.data import video
    from vct_torch.data.clipcache import write_clipcache
    from vct_torch.data.ingest import build_clipcache
    from vct_torch.data.loaders import ClipCacheMapLoader
    from vct_torch.data.samplers import sample_frames

    videos = _synthetic_videos([FILES_RAW] * FILES_CLIPS, seed=150)
    paths = []
    for i, frames in enumerate(videos):
        path = root / "data" / f"class_{i % FILES_CLASSES}" / f"v{i:02d}.avi"
        path.parent.mkdir(parents=True, exist_ok=True)
        _write_avi(path, frames)
        paths.append(path)
    served = _synthetic_videos(FILES_SERVED, seed=151)
    (root / "serve").mkdir()
    for i, frames in enumerate(served):
        _write_avi(root / "serve" / f"@user{i}_video_{1500 + i}.avi", frames)
    decoder = "native" if found["native_decoder"] else "cv2" if found["cv2"] else None
    over = {"data.dataset_path": str(root / "data"),
            "data.processed_data_path": str(root / "cache"), "data.cache_format": "clipcache",
            "data.stream": "true", "data.sequence_length": str(T), "data.img_height": str(H),
            "data.img_width": str(W), "data.sampling_method": "sad",
            "data.decoder": decoder or "cv2", "model.num_classes": str(FILES_CLASSES),
            "model.compute_dtype": "bfloat16", "train.epochs": "1",
            "train.batch_size": str(FILES_BATCH),
            **{f"model.{k}": str(v) for k, v in DEPLOYED.items()}}
    cfg = Config().replace(**over)
    decode_ms = None
    if decoder is None:
        print("decode: unavailable on this host (cv2: no, libavcodec: "
              f"{'yes' if found['ldconfig']['avcodec'] else 'no'})")
        print("decode: replaced by seeded frames (write_clipcache of the host-sampled "
              "seeded clips; the serving CLI's decode_video reads the seeded frames)")
    else:
        t0 = time.perf_counter()
        for path, frames in zip(paths, videos):
            got = video.decode_video(str(path), H, W, decoder=decoder)
            if not np.array_equal(np.stack(got), frames):
                raise AssertionError(f"decode ({decoder}) of {path.name} is not the seeded frames")
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        print(f"decode: {decoder} (vct_torch.data.video.decode_video) ran on all {len(paths)} "
              f"files, {FILES_RAW} frames of {H}x{W} each, bit-equal to the seeded frames; "
              f"{decode_ms:.3f} ms a video")
    want = np.stack([np.stack(sample_frames(list(v), T, "sad")) for v in videos])
    labels = np.arange(FILES_CLIPS) % FILES_CLASSES
    order = np.argsort([f"class_{i % FILES_CLASSES}/v{i:02d}" for i in range(FILES_CLIPS)],
                       kind="stable")
    t0 = time.perf_counter()
    if decoder is None:
        Path(cfg.data.processed_data_path).mkdir(parents=True)
        write_clipcache(cfg.data.data_file, want[order], labels[order])
        np.save(cfg.data.classes_file, np.asarray([f"class_{c}" for c in range(FILES_CLASSES)]))
    else:
        build_clipcache(cfg)
    build_s = time.perf_counter() - t0
    cache = ClipCacheMapLoader(cfg.data.data_file, FILES_BATCH)
    if not (np.array_equal(np.asarray(cache._clips), want[order])
            and np.array_equal(cache.labels, labels[order])):
        raise AssertionError("the clip cache does not hold the host-sampled seeded clips")
    cache.close()
    print(f"ingest: {FILES_CLIPS} clips of {FILES_RAW} frames, {FILES_CLASSES} classes, SAD "
          f"to T={T} on the host, into {Path(cfg.data.data_file).name} in {build_s:.2f} s; "
          "clips and labels equal to the seeded clips sampled in process")
    argv = [a for k, v in over.items() for a in (f"--{k}", v)]
    return argv, cfg, served, decode_ms, build_s


def _files_train(torch, argv: list, cfg, root: Path) -> dict:
    """``python -m vct_torch.train --data.stream true`` for one epoch from
    the clip cache, the kernels' launches read around exactly that run; its
    epoch loss and trained weights held bit-equal to an in-memory ``fit`` on
    the same uint8 clips; then the streamed and in-memory fits timed in turns
    (stream, memory, memory, stream) with the host seconds each batch took
    to come out of the cache."""
    import contextlib
    import io

    from vct_torch.data import loaders
    from vct_torch.train.__main__ import main as train_main
    from vct_torch.train.checkpoint import load_checkpoint
    from vct_torch.train.engine import Trainer

    waits = []
    real_open = loaders.open_cache_loader

    def opened(*args, **kwargs):
        waits.append([])
        return _timed_loader(real_open(*args, **kwargs), waits[-1])

    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), mock.patch.object(loaders, "open_cache_loader", opened):
        rc = train_main(argv + ["--train.model_path", str(root / "ck"),
                                "--train.history_path", str(root / "history.json")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    text = out.getvalue()
    print("\n".join(f"  | {line}" for line in text.splitlines()))
    n_test = int(round(FILES_CLIPS * cfg.data.val_fraction))
    n_train = FILES_CLIPS - n_test
    steps = -(-n_train // FILES_BATCH)
    want = _expected_train_launches(DEPLOYED, steps + -(-n_test // FILES_BATCH), steps)
    print(f"streamed train CLI: rc {rc}, {cli_s:.2f} s; launches {_nonzero(launches)} "
          f"(expected {_nonzero(want)})")
    if rc != 0 or "Model saved to" not in text or launches != want:
        raise AssertionError(f"streamed train CLI: rc {rc}, launches {launches} != {want}")
    streamed_loss = json.loads((root / "history.json").read_text())["train_loss"]
    trained, _, class_names, _ = load_checkpoint(str(root / "ck"))

    train_idx, _ = loaders.split_indices(FILES_CLIPS, cfg.data.val_fraction,
                                         cfg.data.split_seed)
    cache = loaders.ClipCacheMapLoader(cfg.data.data_file, FILES_BATCH, train_idx)
    x, y = np.asarray(cache._clips)[train_idx], cache.labels
    cache.close()
    trainer = Trainer(cfg, class_names)
    state, run = trainer.fit(trainer.init_state(), loaders.ArrayLoader(x, y, FILES_BATCH),
                             log=False)
    got = state.model.state_dict()
    unequal = [k for k, v in trained.items() if not torch.equal(v.to(got[k].device), got[k])]
    print(f"streamed vs in-memory fit on the same uint8 batches: epoch loss "
          f"{streamed_loss} vs {run.epoch_losses}, {len(trained) - len(unequal)} of "
          f"{len(trained)} tensors bit-equal")
    if run.epoch_losses != streamed_loss or unequal:
        raise AssertionError(f"streamed fit differs from the in-memory fit: {unequal[:5]}")
    del trainer, state

    timed_cfg = cfg.replace(**{"train.epochs": str(FILES_TIMED_EPOCHS)})
    trainer = Trainer(timed_cfg, class_names)
    state = trainer.init_state()
    rows = {"stream": [], "memory": []}
    stream_waits = []
    for kind in ("stream", "memory", "memory", "stream"):
        if kind == "stream":
            stream_waits.append([])
            data = _timed_loader(loaders.open_cache_loader(cfg, train_idx), stream_waits[-1])
        else:
            data = loaders.ArrayLoader(x, y, FILES_BATCH)
        state, run = trainer.fit(state, data, log=False)
        rows[kind].append(FILES_TIMED_EPOCHS * n_train / run.training_duration)
    timed_steps = FILES_TIMED_EPOCHS * steps
    loader_s = [sum(w) / timed_steps for w in stream_waits]
    step_s = [FILES_TIMED_EPOCHS * n_train / r / timed_steps for r in rows["stream"]]
    del trainer, state
    torch.cuda.empty_cache()
    feed = _feed_breakdown(torch, cfg, train_idx, x)
    print(f"streamed train: {rows['stream']} clips/s against {rows['memory']} from memory; "
          f"the cache's batches {loader_s} s a step; one batch's feed (ms, best of 5) {feed}")
    return {"streamed_train_clips_per_s": rows["stream"],
            "memory_train_clips_per_s": rows["memory"],
            "loader_s_per_step": loader_s, "streamed_step_s": step_s,
            "cli_loader_s_per_step": sum(waits[0]) / steps, "train_cli_s": cli_s,
            "train_launches": _nonzero(launches), "feed_ms": feed}


def _feed_breakdown(torch, cfg, train_idx, x) -> dict:
    """One B=32 batch's host feed, ms (best of 5): the gather from the clip
    cache's memory map (a fresh map, as each fit opens one) and from the
    same clips in RAM, and its copy to the card from pageable and from
    pinned memory."""
    from vct_torch.data.loaders import ClipCacheMapLoader

    idx = np.random.RandomState(0).permutation(len(train_idx))[:FILES_BATCH]

    def best(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def map_gather():
        cache = ClipCacheMapLoader(cfg.data.data_file, FILES_BATCH, train_idx)
        np.asarray(cache._clips[cache.indices[idx]])

    batch = torch.from_numpy(x[idx])
    pinned = batch.pin_memory()
    return {"gather_map_ms": best(map_gather), "gather_ram_ms": best(lambda: x[idx]),
            "h2d_pageable_ms": best(lambda: batch.to("cuda")),
            "h2d_pinned_ms": best(lambda: pinned.to("cuda", non_blocking=True))}


def _files_serve(torch, root: Path, served: list, decodes: bool) -> dict:
    """``python -m vct_torch.serve.deployment`` on the served AVI files with
    the streamed run's checkpoint: ``--device_sampling`` with sad and ssim,
    host sad (where something decodes) and device sad with ``--post`` to a
    local server; launches read around each run, probabilities held to
    ``classify_videos`` in process on the same clips."""
    import contextlib
    import io

    from vct_torch.data import video
    from vct_torch.data.samplers import sample_frames
    from vct_torch.serve import deployment

    names = sorted(p.name for p in (root / "serve").iterdir())
    t0 = time.perf_counter()
    model, class_names, _ = deployment.load_model(str(root / "ck"))
    load_s = time.perf_counter() - t0
    host = np.stack([np.stack(sample_frames(list(v), T, "sad")) for v in served])
    host = host.astype(np.float32) / 255.0
    reference = {"sad": deployment.sample_decoded_clips(served, "sad", T),
                 "ssim": deployment.sample_decoded_clips(served, "ssim", T), "host": host}
    want, classify_s = {}, {}
    for key, clips in reference.items():
        want[key] = deployment.classify_videos(model, clips)
        t0 = time.perf_counter()
        deployment.classify_videos(model, clips)
        classify_s[key] = (time.perf_counter() - t0) / len(served)
    by_name = dict(zip(names, served))

    def seeded(path, *args, **kwargs):
        return list(by_name[Path(path).name])

    backend = _Backend()
    modes = [("device_sad", "sad", ["--device_sampling", "--sampling", "sad"]),
             ("device_ssim", "ssim", ["--device_sampling", "--sampling", "ssim"]),
             ("host_sad", "host", ["--sampling", "sad"]),
             ("device_sad_post", "sad", ["--device_sampling", "--sampling", "sad", "--post",
                                         "--backend_url", backend.url])]
    counters = _serve_counters()
    out_rows = {}
    try:
        for label, ref, extra in modes:
            if ref == "host" and not decodes:
                print(f"{label}: skipped (nothing decodes on this host; the spawned decode "
                      "workers cannot be given the seeded frames)")
                continue
            for fn in counters.values():
                fn.launches = 0
            out = io.StringIO()
            patch = (contextlib.nullcontext() if decodes
                     else mock.patch.object(video, "decode_video", seeded))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), patch:
                rc = deployment.main(["--model", str(root / "ck"), "--videos",
                                      str(root / "serve"), *extra])
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counters.items()}
            expect = dict.fromkeys(counters, 0)
            if ref != "host":
                scorer = "ssim_pair_scores" if ref == "ssim" else "pair_scores"
                expect[scorer] = sum(n > T for n in FILES_SERVED)
            expect["selective_scan"] = DEPLOYED["rnn_layer"] * -(-len(served) // 32)
            results = _cli_results(out.getvalue())
            err = _hold_cli_probs(label, results, names, class_names, want[ref])
            print(f"serving CLI {label}: rc {rc}, {wall:.3f} s ({wall / len(served):.4f} s a "
                  f"video, classify_videos alone {classify_s[ref]:.4f} s a video); launches "
                  f"{_nonzero(launches)} (expected {_nonzero(expect)}); probabilities within "
                  f"{err} of classify_videos; labels {[r['labels'][0] for r in results]}")
            if rc != 0 or launches != expect:
                raise AssertionError(f"serving CLI {label}: rc {rc}, launches {launches}")
            if "post" in label:
                posted = [(b["url"], b["labels"]) for b in backend.bodies]
                if posted != [(deployment.construct_url(r["video_name"]), r["labels"])
                              for r in results]:
                    raise AssertionError(f"serving CLI {label}: the backend got {posted}")
                print(f"serving CLI {label}: the local backend received {len(posted)} results")
            out_rows[label] = {"cli_s_per_video": wall / len(served),
                               "classify_s_per_video": classify_s[ref],
                               "max_prob_err": err, "launches": _nonzero(launches)}
    finally:
        backend.close()
    del model
    torch.cuda.empty_cache()
    return {"serve": out_rows, "load_model_s": load_s}


def _files_path(torch, gpu, root: Path) -> bool:
    """Phase 15: what the host decodes with, the seeded AVI dataset decoded
    (held bit-equal) and ingested into a clip cache, the streamed train CLI
    (``_files_train``) and the serving CLI (``_files_serve``), all under
    ``root``, where the trained checkpoint (``ck``) and the served files
    (``serve``) stay for phase 16. Returns whether the host decodes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    found = _host_decoders()
    argv, cfg, served, decode_ms, build_s = _files_ingest(root, found)
    train = _files_train(torch, argv, cfg, root)
    serve = _files_serve(torch, root, served, decode_ms is not None)
    summary = {"files": {"host": found, "decode_ms_per_video": decode_ms,
                         "clipcache_build_s": build_s, **train, **serve}, "gpu": gpu}
    print(json.dumps(summary))
    print(f"files phase: {time.perf_counter() - t0:.1f} s")
    return decode_ms is not None


# The worker phase: phase 15's trained checkpoint and served AVI files
# through the port's serving stack (backend, queue, worker, store), as a
# client of the REST backend sees it.
WORKER_BACKLOG = 3  # served files already in VIDEO_DIR when the first message comes
WORKER_BATCH = 32  # classify_videos' batch, the worker's
WORKER_POLL_S = 30.0  # /get_labels gives up after this long
# The worker's stored scores against classify_videos in process on the same clips.
WORKER_TOL = 1e-5
# Clips of the fault 1 check: the peak device memory of classify_videos may
# rise by less than one chunk's f32 bytes from the first count to the second.
FAULT1_CLIPS = (32, 128)


def _video_name(url: str, suffix: str) -> str:
    """The file name the TikTok client gives a video URL:
    ``https://www.tiktok.com/@user/video/<id>`` -> ``@user_video_<id><suffix>``,
    the inverse of ``construct_url``."""
    match = re.search(r"/(@[\w.]+)/video/(\d+)$", url)
    if match is None:
        raise ValueError(f"not a TikTok video URL: {url}")
    return f"{match.group(1)}_video_{match.group(2)}{suffix}"


def _local_downloader(src: Path, suffix: str, seconds: list):
    """A worker ``downloader`` that copies a URL's video from ``src`` (its
    file named by ``_video_name``) into the worker's directory, the seconds
    of each copy appended to ``seconds``."""
    import shutil

    def download(url: str, save_dir: str) -> None:
        t0 = time.perf_counter()
        shutil.copy(src / _video_name(url, suffix), save_dir)
        seconds.append(time.perf_counter() - t0)

    return download


def _fault1_check(torch, model) -> dict:
    """The rise of ``classify_videos``' peak device memory from
    ``FAULT1_CLIPS[0]`` to ``FAULT1_CLIPS[1]`` host clips of T x H x W x 3
    f32 must stay under one chunk's bytes: one chunk is on the device at a
    time."""
    from vct_torch.serve.deployment import classify_videos

    clips = np.random.default_rng(16).random((max(FAULT1_CLIPS), T, H, W, 3), dtype=np.float32)
    chunk = WORKER_BATCH * clips[0].nbytes
    classify_videos(model, clips[:WORKER_BATCH])  # warm
    peaks = {}
    for n in FAULT1_CLIPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        classify_videos(model, clips[:n])
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base
    rise = peaks[FAULT1_CLIPS[1]] - peaks[FAULT1_CLIPS[0]]
    print(f"fault 1: classify_videos' peak device memory {peaks} bytes over the clips held "
          f"before, a rise of {rise} bytes from N={FAULT1_CLIPS[0]} to N={FAULT1_CLIPS[1]} "
          f"host clips against one chunk's {chunk}")
    if not rise < chunk:
        raise AssertionError(f"classify_videos holds more than one chunk on the device: "
                             f"rise {rise} >= {chunk}")
    return {"peak_bytes": peaks, "rise_bytes": rise, "chunk_bytes": chunk}


def _serve_urls(torch, root: Path, model_path: str, urls: list, video_dir: Path, db: Path,
                downloads: list, instrument=None, patches=()) -> tuple:
    """Phase 16's harness, shared with phase 18: a backend on an ephemeral
    port with a ``ResultStore`` at ``db``, the queue, and a
    ``vct_torch.serve.worker.Worker`` on the card with MODEL_PATH
    ``model_path``, host SAD sampling and a local-copy downloader from
    ``root/serve`` into ``video_dir`` (each copy's seconds appended to
    ``downloads``), in threads; a client asks ``GET /get_labels`` for each
    URL. ``instrument(worker)`` runs after the worker is made and before it
    starts; ``patches`` are entered around the flow. Returns (the worker,
    {url: stored row}, [(status, body, seconds)] a URL, ``Worker()``'s
    seconds, what the flow printed)."""
    import io
    import socket
    import threading
    import urllib.parse
    import urllib.request

    from vct_torch.core.config import ServeConfig
    from vct_torch.serve import backend
    from vct_torch.serve import worker as worker_module
    from vct_torch.serve.queue import QueuePull
    from vct_torch.serve.store import ResultStore

    src = root / "serve"
    suffix = next(src.iterdir()).suffix
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        queue_port = s.getsockname()[1]
    store = ResultStore(str(db))
    cfg = ServeConfig(model_path=model_path, sampling_method="sad", sequence_length=T,
                      video_dir=str(video_dir), queue_port=queue_port,
                      backend_host="127.0.0.1", backend_port=0, db_path=store.path)
    server = backend.make_server(cfg, store=store, poll_timeout=WORKER_POLL_S)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    cfg = dataclasses.replace(cfg, backend_base_url=base)
    log = io.StringIO()
    t_load = time.perf_counter()
    with contextlib.redirect_stdout(log):
        w = worker_module.Worker(cfg, downloader=_local_downloader(src, suffix, downloads))
    load_s = time.perf_counter() - t_load
    w.pull = QueuePull(host="127.0.0.1", port=queue_port)
    w.pull.bind()
    if instrument is not None:
        instrument(w)
    replies, server_thread = [], threading.Thread(target=server.serve_forever, daemon=True)
    worker_thread = threading.Thread(target=w.run, daemon=True)
    try:
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            stack.enter_context(contextlib.redirect_stdout(log))
            server_thread.start()
            worker_thread.start()
            for url in urls:
                query = urllib.parse.urlencode({"url": url})
                t = time.perf_counter()
                with urllib.request.urlopen(f"{base}/get_labels?{query}",
                                            timeout=WORKER_POLL_S + 30) as r:
                    replies.append((r.status, json.loads(r.read()), time.perf_counter() - t))
    finally:
        w.pull.close()
        if worker_thread.ident is not None:
            worker_thread.join(timeout=60)
        server.shutdown()
        server.server_close()
        if server_thread.ident is not None:
            server_thread.join(timeout=30)
    torch.cuda.synchronize()
    if worker_thread.is_alive() or server_thread.is_alive():
        raise AssertionError(f"MODEL_PATH={model_path}: the worker or the backend did not stop")
    return w, {r["url"]: r for r in store.all()}, replies, load_s, log.getvalue()


def _worker_messages(records: list, counters) -> list:
    """Phase 16's hold on each message's launches: K3 ``rnn_layer`` times a
    forward, ceil(N/WORKER_BATCH) forwards for N videos, nothing else. A URL
    asked for while the worker still posts an earlier message's rows is
    queued again; its message finds the file classified, deletes it and
    classifies nothing: no forward and no launch. Returns each message's
    seconds, videos and launches."""
    messages = []
    for rec in records:
        n = len(rec.get("names", ()))
        expect = dict.fromkeys(counters, 0)
        expect["selective_scan"] = DEPLOYED["rnn_layer"] * -(-n // WORKER_BATCH)
        if rec["launches"] != expect:
            raise AssertionError(f"phase 16: message {rec['url']}: launches {rec['launches']} "
                                 f"!= {expect}")
        messages.append({k: rec.get(k) for k in ("download_s", "check_s", "decode_select_s",
                                                 "forward_s", "post_s", "callback_s")}
                        | {"videos": n, "launches": _nonzero(rec["launches"])})
    return messages


def _worker_path(torch, gpu, root: Path, decodes: bool) -> None:
    """Phase 16: phase 15's served files behind URLs, served through
    ``vct_torch.serve.backend`` (a ``ResultStore`` under ``root``, an
    ephemeral port), the queue and a ``vct_torch.serve.worker.Worker`` on the
    card with host SAD sampling and a local-copy downloader; a client asks
    ``GET /get_labels`` for each URL. The first ``WORKER_BACKLOG`` others wait
    in VIDEO_DIR, so the first message classifies them too and their URLs
    then come from the store. Launches are read around each message (K3 3 a
    forward, ceil(N/32) forwards; nothing else), the stored scores held to
    ``classify_videos`` in process on clips sampled apart from the worker,
    the store and VIDEO_DIR checked; then the fault 1 check."""
    from vct_torch.data.ingest import load_dataset_inference
    from vct_torch.serve import deployment
    from vct_torch.serve import worker as worker_module

    if not decodes:
        raise AssertionError("phase 16 samples on the host and needs a decoder (cv2)")
    t0 = time.perf_counter()
    src = root / "serve"
    names = sorted(p.name for p in src.iterdir())
    suffix = Path(names[0]).suffix
    urls = [deployment.construct_url(n) for n in names]
    backlog = names[1:1 + WORKER_BACKLOG]
    video_dir = root / "worker_videos"
    video_dir.mkdir()
    for name in backlog:
        (video_dir / name).write_bytes((src / name).read_bytes())
    downloads = []
    counters = _serve_counters()
    records = []

    def timed(key, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            records[-1][key] = time.perf_counter() - t
            if key == "forward_s":
                records[-1]["clips"], records[-1]["names"] = np.array(args[1]), list(args[2])
            return out

        return call

    def instrument(w):
        callback = w.callback

        def counted(url):
            for fn in counters.values():
                fn.launches = 0
            records.append({"url": url})
            t = time.perf_counter()
            try:
                callback(url)
            finally:
                torch.cuda.synchronize()
                records[-1]["callback_s"] = time.perf_counter() - t
                records[-1]["launches"] = {n: fn.launches for n, fn in counters.items()}
                records[-1]["download_s"] = downloads[-1] if downloads else None

        w.callback = counted
        w._already_classified = timed("check_s", w._already_classified)

    patches = [mock.patch.object(worker_module, name, timed(key, getattr(worker_module, name)))
               for name, key in (("load_dataset_inference", "decode_select_s"),
                                 ("classify_and_display", "forward_s"),
                                 ("post_results", "post_s"))]
    w, rows, replies, load_s, log = _serve_urls(torch, root, str(root / "ck"), urls, video_dir,
                                                root / "results.db", downloads, instrument,
                                                patches)
    said = ("Processing message", "Final data shape", "Keeping", "Dropping", "Deleted",
            "Error", "Failed", "No videos")
    print("\n".join(f"  | {line}" for line in log.splitlines() if line.startswith(said)))

    # the client's labels, the store, VIDEO_DIR
    if [r[0] for r in replies] != [200] * len(urls) or sorted(rows) != sorted(urls):
        raise AssertionError(f"phase 16: replies {[r[:2] for r in replies]}, stored {sorted(rows)}")
    for url, (_, body, _) in zip(urls, replies):
        if body != {"url": url, "labels": rows[url]["labels"]}:
            raise AssertionError(f"phase 16: the client got {body} for {url}")
    left = sorted(p.name for p in video_dir.iterdir())
    if left:
        raise AssertionError(f"phase 16: confirmed files left in VIDEO_DIR: {left}")

    # launches around each message, and the scores against classify_videos
    # on clips sampled in process, grouped as the worker grouped them
    ref_clips, ref_names = load_dataset_inference(str(src), "sad", T, H, W, decode_workers=1)
    ref = dict(zip(ref_names, ref_clips))
    messages, err = _worker_messages(records, counters), 0.0
    for rec in records:
        if not rec.get("names"):
            continue
        clips = np.stack([ref[name] for name in rec["names"]])
        if not np.array_equal(clips, rec["clips"]):
            raise AssertionError(f"phase 16: the worker's clips of {rec['names']} differ from "
                                 "load_dataset_inference in process")
        probs = deployment.classify_videos(w.model, clips)
        for name, p in zip(rec["names"], probs):
            row = rows[deployment.construct_url(name)]
            order = np.argsort(-p)
            if row["labels"] != [w.class_names[i] for i in order]:
                raise AssertionError(f"phase 16: labels of {name} differ from classify_videos")
            err = max(err, float(np.abs(np.asarray(row["scores"]) - p[order]).max()))
    if not err <= WORKER_TOL:
        raise AssertionError(f"phase 16: stored scores differ from classify_videos by {err}")

    alone = {}
    for n in (1, len(records[0]["names"])):
        clips = np.stack([ref[name] for name in ref_names[:n]])
        times = []
        for _ in range(3):
            t = time.perf_counter()
            deployment.classify_videos(w.model, clips)
            times.append(time.perf_counter() - t)
        alone[n] = times
    e2e = [r[2] for r in replies]
    for url, (_, body, secs) in zip(urls, replies):
        rec = next((m for m, r in zip(messages, records) if r["url"] == url), None)
        secs_of = {k: "-" if rec is None or rec[k] is None else f"{rec[k]:.4f}"
                   for k in ("download_s", "check_s", "decode_select_s", "forward_s", "post_s",
                             "callback_s")}
        how = (f"a message of {rec['videos']} videos: download {secs_of['download_s']}, check "
               f"{secs_of['check_s']}, decode+select {secs_of['decode_select_s']}, forward "
               f"{secs_of['forward_s']}, POST {secs_of['post_s']}, callback "
               f"{secs_of['callback_s']} s; launches {rec['launches']}" if rec
               else "from the store")
        print(f"worker: {Path(_video_name(url, suffix)).name} -> {body['labels'][0]} in "
              f"{secs:.4f} s end to end, {how}")
    print(f"worker: {len(urls)} URLs, {len(records)} messages, stored scores within {err} of "
          f"classify_videos; Worker() {load_s:.3f} s; classify_videos alone "
          f"{ {n: [round(t, 4) for t in ts] for n, ts in alone.items()} } s")
    fault1 = _fault1_check(torch, w.model)
    del w
    torch.cuda.empty_cache()
    summary = {"worker": {"urls": len(urls), "backlog": len(backlog), "e2e_s": e2e,
                          "messages": messages, "max_score_err": err, "worker_init_s": load_s,
                          "classify_videos_alone_s": alone, "fault1": fault1}, "gpu": gpu}
    print(json.dumps(summary))
    print(f"worker phase: {time.perf_counter() - t0:.1f} s")


# The caption files phase: vct's CaptionConfig at full width (S2VT v2,
# resnet50 in f32, cnn_output_size and hidden_size 512, 30 frames of 224x224,
# beam 3) at the CLI's B=4, trained from a directory of seeded AVI files and
# captioning it. No kernel is on this path, in vct or in the port.
CAPFILES_VIDEOS = 12
CAPFILES_FRAMES = (60, 150)  # each video's length, drawn in this range
CAPFILES_HW = (240, 320)  # 320x240 frames
CAPFILES_CAPTIONS = 2  # captions a video in the annotation file
CAPFILES_WORDS = (5, 12)  # words a caption, from the stand-in vocabulary
CAPFILES_BATCH = 4  # the CLI's batch (vct/caption/__main__.py:100)
CAPFILES_EPOCHS = 2
CAPFILES_CHUNK = 8  # caption_directory's chunk for a checkpoint (vct/caption/infer.py:192)
# Files that exist and do not decode: bytes that are no video, and an AVI cut
# inside its first frame.
CAPFILES_CORRUPT = ("c_garbage", "c_truncated")
# Flags the phase adds to the caption CLI: none, so vct's defaults (the full
# width above) hold.
CAPFILES_ARGS: list = []


def _capfiles_write(root: Path, seed: int = 170) -> tuple:
    """CAPFILES_VIDEOS seeded videos of uint8 noise (lengths in
    CAPFILES_FRAMES, CAPFILES_HW frames) written as AVI files under
    ``root / "videos"``, the corrupt files of CAPFILES_CORRUPT beside them,
    and an annotation file of CAPFILES_CAPTIONS captions a file (the
    readable videos first, so ``peek`` finds one) and one of the readable
    videos alone. Returns ({name: RGB frames}, annotations, readable
    annotations)."""
    rng = np.random.RandomState(seed)
    vids = root / "videos"
    vids.mkdir(parents=True)
    videos = {}
    for i in range(CAPFILES_VIDEOS):
        n = rng.randint(CAPFILES_FRAMES[0], CAPFILES_FRAMES[1] + 1)
        videos[f"v{i:02d}"] = rng.randint(0, 256, (n, *CAPFILES_HW, 3), dtype=np.uint8)
        _write_avi(vids / f"v{i:02d}.avi", videos[f"v{i:02d}"])
    (vids / f"{CAPFILES_CORRUPT[0]}.avi").write_bytes(b"RIFF, but no video follows")
    first = (vids / "v00.avi").read_bytes()
    cut = first.index(b"00db") + 8 + 16  # 16 bytes into the first frame's chunk
    (vids / f"{CAPFILES_CORRUPT[1]}.avi").write_bytes(first[:cut])
    lines = {}
    for name in [*videos, *CAPFILES_CORRUPT]:
        lines[name] = []
        for _ in range(CAPFILES_CAPTIONS):
            k = rng.randint(CAPFILES_WORDS[0], CAPFILES_WORDS[1] + 1)
            words = rng.randint(0, CAPTION_VOCAB - 4, k)
            lines[name].append(f"{name} " + " ".join(f"w{w}" for w in words))
    ann, readable = root / "annotations.txt", root / "readable.txt"
    ann.write_text("\n".join(l for ls in lines.values() for l in ls) + "\n")
    readable.write_text("\n".join(l for n in videos for l in lines[n]) + "\n")
    return videos, ann, readable


def _interval_frames(frames_rgb: np.ndarray, target: int, size: int) -> np.ndarray:
    """What ``extract_frames_interval`` must give for these frames: every
    ``max(1, n // target)``-th frame, in cv2's BGR order, resized to
    size x size by cv2, the last repeated up to ``target``."""
    import cv2

    interval = max(1, len(frames_rgb) // target)
    idx = list(range(0, len(frames_rgb), interval))[:target]
    idx += [idx[-1]] * (target - len(idx))
    return np.stack([cv2.resize(np.ascontiguousarray(frames_rgb[i][..., ::-1]), (size, size))
                     for i in idx])


def _generated_captions(text: str) -> dict:
    """{file name: caption} of the ``Generated Caption:`` lines."""
    out = {}
    for line in text.splitlines():
        name, sep, caption = line.partition(" Generated Caption: ")
        if sep:
            out[name] = caption
    return out


def _epoch_losses(text: str) -> list:
    """The losses of the caption trainer's ``Epoch [k/n], Loss: x`` lines."""
    return [float(m.group(1)) for m in re.finditer(r"^Epoch \[\d+/\d+\], Loss: (\S+)$", text,
                                                   re.MULTILINE)]


def _hold_generated(label: str, got: dict, want: dict) -> None:
    """The CLI's captions must be the in-process ones, file for file."""
    if got != want:
        differ = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
        raise AssertionError(f"{label}: captions differ for {differ}: "
                             f"{[(n, got.get(n), want.get(n)) for n in differ[:3]]}")


def _run_cli(torch, main, argv: list) -> tuple:
    """(exit code, stdout, seconds) of a CLI ``main`` run in process."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def _capfiles_fits(torch, cfg, vocab, vids: Path, readable: Path) -> dict:
    """One epoch of ``fit`` on the readable clips three ways, each from the
    same seeded weights: in memory from ``load_caption_dataset`` (/255 on the
    host), through ``LazyCaptionLoader`` (uint8, /255 on the device, the host
    seconds each batch waits on decode recorded) and in memory again; the
    lazy fit's loss and weights held bit-equal to the first."""
    from vct_torch.caption import data
    from vct_torch.caption.train import CaptionTrainer

    fcfg = dataclasses.replace(cfg, epochs=1, checkpoint_dir="")
    t0 = time.perf_counter()
    x, y, kept = data.load_caption_dataset(str(vids), str(readable), vocab, cfg.num_frames,
                                           cfg.max_caption_len, CAPTION_HW)
    load_s = time.perf_counter() - t0

    def fit(*source):
        trainer = CaptionTrainer(fcfg, vocab)
        state = trainer.init_state()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, losses = trainer.fit(state, *source, batch_size=CAPFILES_BATCH, log=False)
        torch.cuda.synchronize()
        return losses, state.model.state_dict(), time.perf_counter() - t

    mem_losses, mem_weights, mem_s = fit(x, y)
    waits = []
    loader = _timed_loader(data.LazyCaptionLoader(
        str(vids), str(readable), vocab, batch_size=CAPFILES_BATCH, num_frames=cfg.num_frames,
        max_caption_len=cfg.max_caption_len), waits)
    lazy_losses, lazy_weights, lazy_s = fit(loader)
    _, _, mem2_s = fit(x, y)
    # The two divisions by 255 on one clip: the host's (numpy) and the device's.
    raw = loader._decode(0)
    same_input = torch.equal(torch.from_numpy(raw.astype(np.float32) / 255.0),
                             (torch.from_numpy(raw).cuda().to(torch.float32) / 255.0).cpu())
    unequal = [k for k, v in lazy_weights.items() if not torch.equal(v, mem_weights[k])]
    # Each unequal tensor's difference: its norm over the tensor's (phase
    # 14's card-vs-CPU Adam measure), and its largest entry over the
    # tensor's largest.
    diffs = {k: (lazy_weights[k].double() - mem_weights[k].double()) for k in unequal}
    rel_norm = {k: (d.norm() / mem_weights[k].double().norm().clamp_min(1e-30)).item()
                for k, d in diffs.items()}
    rel_max = max([(d.abs().max() / mem_weights[k].double().abs().max().clamp_min(1e-30)).item()
                   for k, d in diffs.items()], default=0.0)
    worst = max(rel_norm, key=rel_norm.get) if rel_norm else None
    rel = rel_norm.get(worst, 0.0)
    print(f"lazy vs in-memory fit, {len(x)} readable clips, epoch 1: loss {lazy_losses} vs "
          f"{mem_losses}, {len(lazy_weights) - len(unequal)} of {len(lazy_weights)} tensors "
          f"bit-equal (the others within {rel:.3g} in norm, worst {worst}, and {rel_max:.3g} "
          f"of their largest entry); the device's /255 "
          f"{'equals' if same_input else 'differs from'} the host's")
    if same_input and (lazy_losses != mem_losses or unequal):
        raise AssertionError(f"lazy fit differs from the in-memory fit: losses {lazy_losses} vs "
                             f"{mem_losses}, tensors {unequal[:5]}")
    # Otherwise the inputs differ by an ulp, which Adam's normalised steps
    # carry to parameters whose gradients sit at the f32 noise floor: the
    # loss within rtol 1e-6, each tensor within CAPTION_TOL in norm.
    if not same_input and not (np.allclose(lazy_losses, mem_losses, rtol=1e-6, atol=0)
                               and rel <= CAPTION_TOL):
        raise AssertionError(f"lazy fit beyond the in-memory fit's: losses {lazy_losses} vs "
                             f"{mem_losses}, {worst} {rel} in norm")
    n = len(x)
    return {"clips": n, "load_caption_dataset_s": load_s, "lazy_train_clips_per_s": n / lazy_s,
            "memory_train_clips_per_s": [n / mem_s, n / mem2_s],
            "decode_wait_s_per_step": sum(waits) / len(waits), "steps": len(waits),
            "lazy_epoch1_loss": lazy_losses[0], "memory_epoch1_loss": mem_losses[0],
            "lazy_bit_equal_memory": not unequal and lazy_losses == mem_losses,
            "lazy_weights_rel_norm_err": rel, "lazy_weights_rel_max_err": rel_max,
            "worst_tensor": worst, "tensors_unequal": len(unequal),
            "device_div_equals_host_div": same_input}


def _capfiles_caption(torch, vids: Path, ck: Path, names: list, cfg) -> dict:
    """``--caption_videos`` on the directory with the checkpoint ``ck``: one
    ``Generated Caption:`` line a readable video, the corrupt files skipped
    with a print, the captions those of ``caption_videos`` in process on
    clips decoded apart in the same chunks."""
    from vct_torch.caption import data
    from vct_torch.caption.__main__ import main
    from vct_torch.caption.train import restore_caption_trainer

    rc, text, cli_s = _run_cli(torch, main, ["--caption_videos", str(vids), "--model", str(ck)])
    print("\n".join(f"  | {line}" for line in text.splitlines()))
    got = _generated_captions(text)
    skipped = [c for c in CAPFILES_CORRUPT if f"Error processing {c}.avi" in text]
    if rc != 0 or sorted(got) != sorted(f"{n}.avi" for n in names) \
            or len(skipped) != len(CAPFILES_CORRUPT):
        raise AssertionError(f"--caption_videos: rc {rc}, captioned {sorted(got)}, skipped "
                             f"{skipped}")
    trainer, state, _ = restore_caption_trainer(str(ck))
    paths = sorted(p for p in vids.iterdir() if p.suffix == ".avi")
    want, alone = {}, 0.0
    for start in range(0, len(paths), CAPFILES_CHUNK):
        clips, kept = [], []
        for p in paths[start : start + CAPFILES_CHUNK]:
            try:
                clips.append(data.extract_frames_interval(str(p), cfg.num_frames, CAPTION_HW))
            except (OSError, ValueError):
                continue
            kept.append(p.name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words = trainer.caption_videos(state, np.stack(clips))
        torch.cuda.synchronize()
        alone += time.perf_counter() - t0
        want.update((n, " ".join(w)) for n, w in zip(kept, words))
    _hold_generated(f"--caption_videos {ck.name}", got, want)
    words = sum(len(c.split()) for c in got.values())
    print(f"--caption_videos {ck.name}: {len(got)} captions ({words} words) equal to "
          f"caption_videos in process, {cli_s:.2f} s ({cli_s / len(got):.4f} s a video; "
          f"caption_videos alone {alone / len(got):.4f} s a video)")
    return {"caption_cli_s_per_video": cli_s / len(got),
            "caption_videos_s_per_video": alone / len(got), "captioned": len(got),
            "words": words}


def _capfiles_refuse_artifact(torch, vids: Path, root: Path) -> str:
    """A ``vct`` caption artifact (StableHLO for JAX) as ``--model`` must
    raise naming the converter; returns the message."""
    import zipfile

    from vct_torch.caption.__main__ import main

    art = root / "captioner.vctaot"
    with zipfile.ZipFile(art, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "vct-aot-caption-v1",
                                                 "platform": "tpu"}))
    try:
        _run_cli(torch, main, ["--caption_videos", str(vids), "--model", str(art)])
    except ValueError as e:
        if "convert_vct_checkpoint.py SRC DST" not in str(e):
            raise
        print(f"--caption_videos with a vct .vctaot --model: {e}")
        return str(e)
    raise AssertionError("--caption_videos took a vct artifact as --model")


def _caption_files_path(torch, gpu, root: Path) -> None:
    """Phase 17: captioning from video files at vct's full CaptionConfig:
    the seeded AVI files and annotations (``_capfiles_write``), the frames
    ``extract_frames_interval`` gives held to the seeded ones, ``python -m
    vct_torch.caption --video_dir --annotations --eval`` for CAPFILES_EPOCHS
    epochs, the lazy and in-memory fits (``_capfiles_fits``) and
    ``--caption_videos`` (``_capfiles_caption``); every launch counter read
    around the whole phase and required to be 0."""
    import cv2

    from vct_torch.caption import data
    from vct_torch.caption.__main__ import main
    from vct_torch.caption.train import CaptionTrainer
    from vct_torch.caption.vocab import Vocabulary
    from vct_torch.core.config import CaptionConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    videos, ann, readable = _capfiles_write(root)
    vids = root / "videos"
    write_s = time.perf_counter() - t0

    target = CaptionConfig().num_frames
    decode_s = 0.0
    for name, frames in videos.items():
        t = time.perf_counter()
        got = data.extract_frames_interval(str(vids / f"{name}.avi"), target, CAPTION_HW,
                                           as_uint8=True)
        decode_s += time.perf_counter() - t
        if not np.array_equal(got, _interval_frames(frames, target, CAPTION_HW)):
            raise AssertionError(f"extract_frames_interval of {name}.avi is not the seeded "
                                 "frames (BGR, interval, last-frame padding)")
    corrupt = {}
    for name in CAPFILES_CORRUPT:
        try:
            data.extract_frames_interval(str(vids / f"{name}.avi"), target, CAPTION_HW)
        except (OSError, ValueError) as e:
            corrupt[name] = type(e).__name__
        else:
            raise AssertionError(f"{name}.avi decoded")
    decode_ms = decode_s * 1e3 / len(videos)
    print(f"extract_frames_interval (cv2 {cv2.__version__}): {len(videos)} AVI files of "
          f"{CAPFILES_FRAMES[0]}-{CAPFILES_FRAMES[1]} frames of {CAPFILES_HW[1]}x"
          f"{CAPFILES_HW[0]}, {target} frames of {CAPTION_HW}x{CAPTION_HW} each equal to the "
          f"seeded frames chosen in BGR at the interval, last frame padded; {decode_ms:.3f} ms "
          f"a video; the corrupt files raise {corrupt}")

    ck = root / "caption_ck"
    rc, text, train_cli_s = _run_cli(torch, main, [
        "--video_dir", str(vids), "--annotations", str(ann), "--epochs", str(CAPFILES_EPOCHS),
        "--eval", "--batch_size", str(CAPFILES_BATCH), "--checkpoint_dir", str(ck),
        *CAPFILES_ARGS])
    print("\n".join(f"  | {line}" for line in text.splitlines()))
    losses = _epoch_losses(text)
    bleu = [l for l in text.splitlines() if l.startswith("Average BLEU score:")]
    skipped = [c for c in CAPFILES_CORRUPT if f"Error processing {c}.avi" in text]
    manifest = json.loads((ck / "manifest.json").read_text()) if (ck / "manifest.json").exists() \
        else {}
    if rc != 0 or len(losses) != CAPFILES_EPOCHS or len(bleu) != 1 or "Caption:" not in text \
            or len(skipped) != len(CAPFILES_CORRUPT) or manifest.get("epoch") != CAPFILES_EPOCHS:
        raise AssertionError(f"caption training CLI from files: rc {rc}, losses {losses}, "
                             f"skipped {skipped}, manifest epoch {manifest.get('epoch')}")
    cfg = CaptionConfig(**manifest["config"])
    n_items = len(data.preprocess_annotations(str(ann))[0])
    print(f"caption training CLI from files: rc 0, {train_cli_s:.2f} s, losses {losses}, "
          f"{bleu[0]}; its epoch 1 drew a permutation of all {n_items} annotated items and "
          f"masked the {CAPFILES_CAPTIONS * len(CAPFILES_CORRUPT)} rows of the corrupt files, "
          "which load_caption_dataset leaves out, so its loss is not the in-memory fit's: the "
          "lazy and in-memory fits below take the readable items alone")
    vocab = Vocabulary.from_dict(manifest["vocab"])
    fits = _capfiles_fits(torch, cfg, vocab, vids, readable)
    caption = _capfiles_caption(torch, vids, ck, list(videos), cfg)
    # Two epochs on random words can teach the model to end every caption at
    # once; the seeded, untrained weights caption in words, so they are held
    # too.
    seeded = root / "seeded_ck"
    trainer = CaptionTrainer(cfg, vocab)
    trainer.save_checkpoint(str(seeded), trainer.init_state(), 0, 0.0)
    del trainer
    caption_seeded = _capfiles_caption(torch, vids, seeded, list(videos), cfg)
    refusal = _capfiles_refuse_artifact(torch, vids, root)
    torch.cuda.synchronize()
    _require_no_launches("caption files phase", counters)
    torch.cuda.empty_cache()
    summary = {"caption_files": {"videos": len(videos), "write_s": write_s,
                                 "decode_ms_per_video": decode_ms, "corrupt": corrupt,
                                 "train_cli_s": train_cli_s, "cli_epoch_losses": losses,
                                 "cli_bleu": float(bleu[0].split(":")[1]), **fits, **caption,
                                 "seeded_checkpoint": caption_seeded, "vctaot": refusal,
                                 "launches": 0}, "gpu": gpu}
    print(json.dumps(summary))
    print(f"caption files phase: {time.perf_counter() - t0:.1f} s")


# The AOT phase: one-file torch.export artifacts (vct_torch.serve.aot) of
# phase 15's trained checkpoint, of seeded models for the kernels that
# checkpoint does not reach, and of phase 17's caption checkpoint, each held
# to the eager path on the same clips in the same process, the kernels'
# launches read around every artifact call; then the artifact through the
# deployment CLI, the worker and directory captioning.
AOT_TOL = 1e-5  # artifact against eager, same clips, same chunks
AOT_RAW_LEN = 2 * T  # one 120-frame raw video a row
AOT_BATCH = 32
AOT_WORKER_URLS = 3
AOT_CAPTION_BUCKETS = "1,4"
# Modules a classifier artifact's server must not import: the model zoo,
# the config, the host-side preprocessing and the trainer.
AOT_NO_ZOO = ("vct_torch.models", "vct_torch.core.config", "vct_torch.data.preprocess",
              "vct_torch.train")


def _aot_counted(torch, fn, *args):
    """(fn(*args), the kernels' launches during the call)."""
    counters = _serve_counters()
    for c in counters.values():
        c.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {n: c.launches for n, c in counters.items()}


def _aot_expect(launches: dict, want: dict, label: str) -> None:
    """Fail unless the launches are ``want`` (every other counter 0) and at
    least one kernel launched: an artifact whose counters stay at 0 would
    hold a plain version."""
    full = dict.fromkeys(launches, 0) | want
    if launches != full or not any(launches.values()):
        raise AssertionError(f"{label}: launches {_nonzero(launches)} != {_nonzero(full)}")


def _aot_time(torch, fn, reps: int = 3) -> list:
    """Seconds of ``fn()`` (which ends on the host), ``reps`` times, sorted."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def _aot_load(path: Path, export_s: float) -> tuple:
    """(servable, load seconds, warmup seconds, file MB), printed beside the
    export's seconds."""
    import zipfile

    import torch

    from vct_torch.serve.aot import AotServable, CaptionAotServable

    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    cls = CaptionAotServable if "vocab" in manifest else AotServable
    t0 = time.perf_counter()
    sv = cls.load(str(path))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sv.warmup()
    torch.cuda.synchronize()
    warm_s, mb = time.perf_counter() - t0, path.stat().st_size / 1e6
    print(f"aot {path.name}: export {export_s:.2f} s, {mb:.2f} MB, load {load_s:.2f} s, "
          f"warmup {warm_s:.3f} s")
    return sv, load_s, warm_s, mb


def _aot_eager(torch, model, seq_len: int, method):
    """The eager forward an artifact holds, for ``aot._run_bucketed``: the
    softmax of the model, after ``device_sample_clips`` where ``method``."""
    from vct_torch.data.preprocess import device_sample_clips

    def forward(*args):
        x = (device_sample_clips(args[0], seq_len, method=method, lengths=args[1])
             if method else args[0])
        return torch.softmax(model(x).to(torch.float32), dim=-1)

    return forward


def _aot_classifier(torch, label, sv, model, seq_len, method, want: dict, arrays, bench) -> dict:
    """Hold one classifier artifact to its eager forward on ``arrays`` (the
    same chunks, through ``aot._run_bucketed``), its launches ``want`` a
    chunk; then time it and the eager path at B=32 (``bench``) and, where
    it has a bucket of 1, at B=1 (the first row), in turns."""
    from vct_torch.serve import aot

    eager = _aot_eager(torch, model, seq_len, method)
    call = sv.classify_raw if method else sv.classify
    chunks = -(-len(arrays[0]) // sv.buckets[-1])
    got, launches = _aot_counted(torch, call, *arrays)
    _aot_expect(launches, {k: v * chunks for k, v in want.items()}, label)
    stage = aot._make_stager(sv.device)

    def run_eager(arrs):
        with torch.inference_mode():
            (p,) = aot._run_bucketed({b: eager for b in sv.buckets}, list(sv.buckets), arrs,
                                     stage, empty=(np.zeros((0, 1), np.float32),))
        return p

    ref = run_eager(arrays)
    err = float(np.abs(got - ref).max())
    if not err <= AOT_TOL:
        raise AssertionError(f"{label}: artifact differs from the eager path by {err}")
    row = {"max_prob_err": err, "launches_per_chunk": _nonzero(want), "rows": len(ref)}
    sizes = [n for n in (1, AOT_BATCH) if n in sv.buckets]
    for n in sizes:
        arrs = tuple(a[:n] for a in bench)
        art_s = _aot_time(torch, lambda: call(*arrs))
        eager_s = _aot_time(torch, lambda: run_eager(arrs))
        if n == 1:
            row["b1_latency_s"], row["b1_eager_latency_s"] = art_s, eager_s
        else:
            row["b32_clips_per_s"] = [n / t for t in art_s]
            row["b32_eager_clips_per_s"] = [n / t for t in eager_s]
    print(f"aot {label}: within {err} of the eager path over {len(ref)} rows, launches "
          f"{_nonzero(launches)} ({chunks} chunks); "
          + "; ".join(f"{k} {[round(x, 5) for x in v]}" for k, v in row.items()
                      if isinstance(v, list)))
    return row


def _aot_cli(torch, argv: list, path: Path) -> float:
    """``python -m vct_torch.serve.aot`` in process: its seconds."""
    from vct_torch.serve.aot import main

    rc, text, secs = _run_cli(torch, main, [*argv, "--out", str(path)])
    print(f"  | {text.strip()}")
    if rc != 0 or not text.startswith(f"exported {path}"):
        raise AssertionError(f"python -m vct_torch.serve.aot {argv}: rc {rc}, {text!r}")
    return secs


@contextlib.contextmanager
def _aot_no_zoo(path: Path):
    """Around the block, a fresh interpreter loads the dense artifact,
    classifies one clip on the card and lists its modules; after it, the
    check fails if any of AOT_NO_ZOO is among them, and the yielded dict
    holds the port's modules the process imported. The process is killed if
    the block raises."""
    here = Path(__file__).resolve().parent
    code = (f"import json, sys; sys.path.insert(0, {str(here)!r})\n"
            "import numpy as np\n"
            "from vct_torch.serve.aot import AotServable\n"
            f"sv = AotServable.load({str(path)!r})\n"
            "p = sv.classify(np.zeros((1,) + sv.input_shape, np.float32))\n"
            "assert p.shape == (1, len(sv.class_names)) and sv.device.type == 'cuda'\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=here)
    result: dict = {}
    try:
        yield result
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"aot no-zoo subprocess: rc {proc.returncode}\n{err[-3000:]}")
        mods = json.loads(out.strip().splitlines()[-1])
        zoo = sorted(m for m in mods if m.startswith(AOT_NO_ZOO))
        result["modules"] = sorted(m for m in mods if m.startswith("vct_torch"))
        print(f"aot no-zoo: a fresh process loaded and served the dense artifact on the card in "
              f"{time.perf_counter() - t0:.2f} s importing {result['modules']}")
        if zoo:
            raise AssertionError(f"serving an artifact imported {zoo}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _aot_deployment_cli(torch, root: Path, ck: str, dense: Path, names: list) -> dict:
    """``python -m vct_torch.serve.deployment`` over phase 15's served files
    with the checkpoint and with the dense artifact: the same labels, scores
    within AOT_TOL (both run one zero-padded B=32 chunk)."""
    from vct_torch.serve import deployment

    cli = {}
    for key, model_path in (("checkpoint", ck), ("artifact", str(dense))):
        rc, text, secs = _run_cli(torch, deployment.main,
                                  ["--model", model_path, "--videos", str(root / "serve")])
        if rc != 0:
            raise AssertionError(f"deployment CLI --model {key}: rc {rc}")
        cli[key] = ({r["video_name"]: r for r in _cli_results(text)}, secs)
    (by_ck, ck_s), (by_art, art_s) = cli["checkpoint"], cli["artifact"]
    if sorted(by_art) != names or any(by_art[n]["labels"] != by_ck[n]["labels"] for n in names):
        raise AssertionError("deployment CLI: the artifact's labels are not the checkpoint's")
    err = max(float(np.abs(np.asarray(by_art[n]["scores"]) - by_ck[n]["scores"]).max())
              for n in names)
    if not err <= AOT_TOL:
        raise AssertionError(f"deployment CLI: artifact scores differ by {err}")
    print(f"aot deployment CLI --model dense.vctaot: {len(by_art)} videos, labels of the "
          f"checkpoint, scores within {err}; {art_s:.2f} s against the checkpoint's {ck_s:.2f} s")
    return {"max_score_err": err, "artifact_s": art_s, "checkpoint_s": ck_s}


def _aot_worker_hold(torch, root: Path, dense: Path, model, class_names: list, names: list,
                     clips: dict) -> dict:
    """Phase 16's flow over AOT_WORKER_URLS URLs with MODEL_PATH the dense
    artifact. Each message brings one video, which the artifact runs in its
    bucket of 1 where phase 16's checkpoint worker ran a zero-padded B=32
    forward; the bf16 convolutions round differently at the two batch
    sizes, so the stored scores are held to the checkpoint's forward at the
    artifact's batch size (``clips``: the host-sampled clips by name), and
    their distance to the scores phase 16 stored is printed."""
    from vct_torch.serve.deployment import classify_videos, construct_url
    from vct_torch.serve.store import ResultStore

    urls = [construct_url(n) for n in names[:AOT_WORKER_URLS]]
    ck_rows = {r["url"]: r for r in ResultStore(str(root / "results.db")).all()}
    counters = _serve_counters()

    def zero(_worker):
        for c in counters.values():
            c.launches = 0

    video_dir = root / "aot_worker_videos"
    video_dir.mkdir()
    _, art_rows, _, _, _ = _serve_urls(torch, root, str(dense), urls, video_dir,
                                       root / "aot_worker.db", [], zero)
    launches = {n: c.launches for n, c in counters.items()}
    if sorted(art_rows) != sorted(urls):
        raise AssertionError(f"aot worker: stored {sorted(art_rows)}")
    _aot_expect(launches, {"selective_scan": DEPLOYED["rnn_layer"] * len(urls)}, "aot worker")
    err = to_ck = 0.0
    same = 0
    for name, url in zip(names, urls):
        p = classify_videos(model, clips[name][None], batch_size=1)[0]
        order = np.argsort(-p)
        row = art_rows[url]
        if row["labels"] != [class_names[i] for i in order]:
            raise AssertionError(f"aot worker: labels of {url} differ from the checkpoint's")
        err = max(err, float(np.abs(np.asarray(row["scores"]) - p[order]).max()))
        to_ck = max(to_ck, float(np.abs(np.asarray(row["scores"]) - ck_rows[url]["scores"]).max()))
        same += row["labels"] == ck_rows[url]["labels"]
    if not err <= AOT_TOL:
        raise AssertionError(f"aot worker: stored scores differ by {err}")
    print(f"aot worker MODEL_PATH=dense.vctaot: {len(urls)} URLs, scores within {err} of the "
          f"checkpoint's at B=1; against phase 16's checkpoint worker (B=32) within {to_ck}, "
          f"{same}/{len(urls)} labels equal; launches {_nonzero(launches)}")
    return {"urls": len(urls), "max_score_err": err, "to_checkpoint_worker": to_ck,
            "labels_equal": same}


def _aot_caption_videos(torch, vids: Path, cap_ck: Path, cap_art: Path, hw: list) -> None:
    """``--caption_videos`` over phase 17's files with the caption
    checkpoint and with its artifact: the same captions."""
    from vct_torch.caption.__main__ import main

    captions = {}
    for key, model_path in (("checkpoint", cap_ck), ("artifact", cap_art)):
        rc, text, secs = _run_cli(torch, main,
                                  ["--caption_videos", str(vids), "--model", str(model_path), *hw])
        captions[key] = (_generated_captions(text), secs)
        if rc != 0 or not captions[key][0]:
            raise AssertionError(f"--caption_videos with the {key}: rc {rc}, captioned nothing")
    _hold_generated("--caption_videos caption.vctaot", captions["artifact"][0],
                    captions["checkpoint"][0])
    print(f"aot --caption_videos --model caption.vctaot: {len(captions['artifact'][0])} captions "
          f"equal to the checkpoint's; {captions['artifact'][1]:.2f} s against "
          f"{captions['checkpoint'][1]:.2f} s")


def _aot_path(torch, gpu, root: Path) -> None:
    """Phase 18: artifacts of phase 15's checkpoint (dense with two buckets,
    raw SAD), of seeded models (raw SSIM for K4, the UCF50 LSTM for K2, a
    bidirectional GRU for K5; one bucket each) and of phase 17's caption
    checkpoint, each held to the eager path with its launches counted; then
    the deployment CLI, the worker and ``--caption_videos`` with the
    artifacts, and the no-zoo import check. Runs under phase 15-17's root."""
    from vct_torch.caption import data as caption_data
    from vct_torch.caption.beam import beam_search
    from vct_torch.caption.train import restore_caption_trainer
    from vct_torch.core.config import ModelConfig
    from vct_torch.data.ingest import load_dataset_inference
    from vct_torch.models import build_model
    from vct_torch.serve import aot, deployment

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    art = root / "aot"
    art.mkdir()
    rng = np.random.RandomState(180)
    ck = str(root / "ck")
    rows, files = {}, {}

    # phase 15's checkpoint: dense (two buckets) and raw SAD, through the CLI
    dense, raw_sad = art / "dense.vctaot", art / "sad.vctaot"
    export_s = {"dense": _aot_cli(torch, ["--model", ck, "--batches", f"1,{AOT_BATCH}"], dense),
                "sad": _aot_cli(torch, ["--model", ck, "--device_sampling", "sad", "--raw_len",
                                        str(AOT_RAW_LEN)], raw_sad)}
    model, class_names, _ = deployment.load_model(ck)
    served_names = sorted(p.name for p in (root / "serve").iterdir())
    served_clips, sampled_names = load_dataset_inference(str(root / "serve"), "sad", T, H, W,
                                                         decode_workers=1)
    served_raw = np.zeros((len(FILES_SERVED), AOT_RAW_LEN, H, W, 3), np.uint8)
    for i, frames in enumerate(_synthetic_videos(FILES_SERVED, seed=151)):
        served_raw[i, :len(frames)] = frames
    served_lens = np.asarray(FILES_SERVED, np.int32)
    bench_clips = rng.random_sample((AOT_BATCH, T, H, W, 3)).astype(np.float32)
    bench_raw = rng.randint(0, 256, (AOT_BATCH, AOT_RAW_LEN, H, W, 3), dtype=np.uint8)
    bench_lens = rng.randint(T + 1, AOT_RAW_LEN + 1, size=AOT_BATCH).astype(np.int32)
    scan = {"selective_scan": DEPLOYED["rnn_layer"]}
    for key, path, method, want, arrays, bench in (
            ("dense", dense, None, scan, (served_clips,), (bench_clips,)),
            ("sad", raw_sad, "sad", scan | {"pair_scores": 1}, (served_raw, served_lens),
             (bench_raw, bench_lens))):
        sv, load_s, warm_s, mb = _aot_load(path, export_s[key])
        rows[key] = {"export_s": export_s[key], "mb": mb, "load_s": load_s, "warmup_s": warm_s,
                     **_aot_classifier(torch, f"{key} (phase 15's checkpoint)", sv, model, T,
                                       method, want, arrays, bench)}
        files[key] = sv
    del files["sad"]

    # seeded models for K4, K2 and K5, one bucket each
    seeded = (("ssim", DEPLOYED, T, "ssim", scan | {"ssim_pair_scores": 1}),
              ("ucf50_lstm", {**UCF50, "rnn_type": "lstm"}, T_UCF50, None, {"lstm_stack": 1}),
              ("ucf50_bigru", {**UCF50, "rnn_type": "gru", "bidirectional": True}, T_UCF50, None,
               {"gru_scan": 2 * UCF50["rnn_layer"]}))
    for key, cfg, seq_len, method, want in seeded:
        net = build_model(ModelConfig(**cfg, compute_dtype="bfloat16"), seq_len, seed=18)
        names = [f"class_{i}" for i in range(ModelConfig(**cfg).num_classes)]
        path = art / f"{key}.vctaot"
        t0 = time.perf_counter()
        aot.export_servable(net, names, (seq_len, H, W, 3), str(path), batch_sizes=(AOT_BATCH,),
                            device_sampling=method, raw_len=AOT_RAW_LEN if method else None)
        torch.cuda.synchronize()
        export = time.perf_counter() - t0
        sv, load_s, warm_s, mb = _aot_load(path, export)
        if method:
            arrays = (bench_raw, bench_lens)
        else:
            arrays = (rng.random_sample((AOT_BATCH, seq_len, H, W, 3)).astype(np.float32),)
        rows[key] = {"export_s": export, "mb": mb, "load_s": load_s, "warmup_s": warm_s,
                     **_aot_classifier(torch, f"{key} (seeded)", sv, net, seq_len, method, want,
                                       arrays, arrays)}
        del sv, net
        torch.cuda.empty_cache()

    # phase 17's caption checkpoint, through the CLI
    cap_ck = root / "captions" / "caption_ck"
    cap_art = art / "caption.vctaot"
    hw = [a for side in ("--height", "--width") for a in (side, str(CAPTION_HW))]
    export = _aot_cli(torch, ["--model", str(cap_ck), "--batches", AOT_CAPTION_BUCKETS, *hw],
                      cap_art)
    csv, load_s, warm_s, mb = _aot_load(cap_art, export)
    trainer, state, cfg = restore_caption_trainer(str(cap_ck))
    vids = root / "captions" / "videos"
    clips = []
    for p in sorted(vids.glob("*.avi")):
        try:
            clips.append(caption_data.extract_frames_interval(str(p), cfg.num_frames, CAPTION_HW))
        except (OSError, ValueError):
            continue
    clips = np.stack(clips)
    (tokens, scores), launches = _aot_counted(torch, csv.decode, clips)
    if _nonzero(launches):
        raise AssertionError(f"caption artifact: kernels launched on a path that reaches none: "
                             f"{_nonzero(launches)}")

    def eager_beam(video):
        return beam_search(state.model, video, beam_width=csv.beam_width, max_len=csv.max_len)

    with torch.inference_mode():
        want_tokens, want_scores = aot._run_bucketed(
            {b: eager_beam for b in csv.buckets}, list(csv.buckets), (clips,),
            aot._make_stager(csv.device), empty=(np.zeros((0, csv.max_len + 1), np.int64),
                                                 np.zeros((0,), np.float32)))
    err = float(np.abs(scores - want_scores).max())
    if not (np.array_equal(tokens, want_tokens) and err <= AOT_TOL):
        raise AssertionError(f"caption artifact: tokens equal {np.array_equal(tokens, want_tokens)}"
                             f", scores within {err}")
    one = clips[:1]
    cap_row = {"export_s": export, "mb": mb, "load_s": load_s, "warmup_s": warm_s,
               "max_score_err": err, "tokens_equal": True, "rows": len(clips),
               "b1_latency_s": _aot_time(torch, lambda: csv.decode(one)),
               "b1_eager_latency_s": _aot_time(torch, lambda: eager_beam(
                   torch.from_numpy(one).cuda())[0].cpu())}
    print(f"aot caption (phase 17's checkpoint): {len(clips)} clips, tokens equal to beam_search, "
          f"scores within {err}; B=1 {cap_row['b1_latency_s']} s against eager "
          f"{cap_row['b1_eager_latency_s']} s")
    rows["caption"] = cap_row
    del trainer, state

    # the consumers, and the no-zoo check in its own process meanwhile
    with _aot_no_zoo(dense) as no_zoo:
        cli = _aot_deployment_cli(torch, root, ck, dense, served_names)
        worker = _aot_worker_hold(torch, root, dense, model, class_names, served_names,
                                  dict(zip(sampled_names, served_clips)))
        _aot_caption_videos(torch, vids, cap_ck, cap_art, hw)
    modules = no_zoo["modules"]
    del files, model, csv
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(json.dumps({"aot": {**rows, "deployment_cli": cli, "worker": worker,
                              "no_zoo_modules": modules, "phase_s": secs}, "gpu": gpu}))
    print(f"aot phase: {secs:.1f} s")


# Phase 19, sweeps: the grid over the deployed configuration's three heads at
# full width (40 synthetic clips: 32 train, 8 test, B=32, 2 epochs).
SWEEP_SPACE = {"model.rnn_type": ["mamba", "lstm", "gru"]}
SWEEP_MEMORY_SLACK = 64 << 20  # bytes a trial may leave above the first trial's level
SWEEP_PROBE_CLIPS = 4  # clips the best models classify, against the trials' own models
SWEEP_TOL = 1e-5
# The subprocess trial: small, a python -m vct_torch.train child on the card.
SWEEP_CHILD = {"model.cnn_backbone": "resnet18", "data.sequence_length": "8",
               "data.img_height": "32", "data.img_width": "32", "data.synthetic_samples": "8",
               "train.batch_size": "4", "train.epochs": "1"}
# TPE and the genetic algorithm on the rehearsal's configuration, small.
SWEEP_TPE_TRIALS, SWEEP_SMALL_EPOCHS = 8, 3
SWEEP_GA_POPULATION, SWEEP_GA_GENERATIONS = 4, 2


def _sweep_guard(torch, trials: list):
    """A ``SweepRunner`` whose every trial is timed, has the head kernels'
    launch counters read around it and the device memory read after it. A
    trial that raises is recorded with its traceback (the runner would log it
    and go on), so the phase fails on it and never counts it as a result."""
    import traceback

    from vct_torch.sweep.runner import SweepRunner

    counters = _train_counters()

    class Guarded(SweepRunner):
        def _train_once(self, cfg):
            t = cfg.train
            record = {"trial": f"{cfg.model.rnn_type} lr {t.learning_rate:.4g} B {t.batch_size} "
                               f"seed {t.seed}"}
            trials.append(record)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            try:
                metrics = super()._train_once(cfg)
            except Exception:
                record["error"] = traceback.format_exc()
                print(f"sweep trial {record['trial']} raised:\n{record['error']}", flush=True)
                raise
            torch.cuda.synchronize()
            record.update(s=time.perf_counter() - t0,
                          launches={n: fn.launches for n, fn in counters.items()},
                          memory=torch.cuda.memory_allocated(), f1=metrics.f1,
                          accuracy=metrics.accuracy)
            return metrics

    return Guarded


def _sweep_hold_trials(label: str, trials: list) -> None:
    """Fail on a trial that raised, on one whose head kernels never
    launched, and on memory that grew past the first trial's level."""
    failed = [r["trial"] for r in trials if "error" in r]
    if failed:
        raise AssertionError(f"{label}: trials raised: {failed}")
    for r in trials:
        print(f"  {label} trial {r['trial']}: {r['s']:.2f} s, F1 {r['f1']:.4f}, accuracy "
              f"{r['accuracy']:.4f}, memory_allocated {r['memory']} B, launches "
              f"{_nonzero(r['launches'])}")
        if not any(r["launches"].values()):
            raise AssertionError(f"{label}: trial {r['trial']} launched no kernel")
    top = trials[0]["memory"] + SWEEP_MEMORY_SLACK
    grown = [(r["trial"], r["memory"]) for r in trials[1:] if r["memory"] > top]
    if grown:
        raise AssertionError(f"{label}: device memory grew past the first trial's "
                             f"{trials[0]['memory']} B + {SWEEP_MEMORY_SLACK}: {grown}")


def _sweep_main(torch, run) -> tuple:
    """(result, stdout) of ``run()`` in process; the output echoed."""
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = run()
        torch.cuda.synchronize()
    finally:
        print("\n".join(f"  | {line}" for line in out.getvalue().splitlines()), flush=True)
    return result, out.getvalue()


def _sweep_grid(torch, root: Path) -> dict:
    """(a) ``python -m vct_torch.sweep --strategy grid`` in process at the
    deployed configuration, one trial a head, each trial's launches held to
    its steps; the same argv again skips every configuration, launches
    nothing and leaves the store's bytes as they were. (b) Each trial's
    best-model directory loads through ``load_model`` and classifies the
    probe clips within ``SWEEP_TOL`` of the trial's own trained model."""
    from vct_torch.serve.deployment import classify_videos, load_model
    from vct_torch.sweep import __main__ as sweep_main
    from vct_torch.sweep.store import SweepStore
    from vct_torch.train.engine import Trainer

    space = root / "space.json"
    space.write_text(json.dumps(SWEEP_SPACE))
    argv = ["--strategy", "grid", "--space", str(space), "--data.synthetic", "true",
            "--data.synthetic_samples", str(TRAIN_SAMPLES), "--data.sequence_length", str(T),
            "--data.img_height", str(H), "--data.img_width", str(W),
            "--model.compute_dtype", "bfloat16", "--train.feature_cache", "true",
            "--train.batch_size", str(TRAIN_BATCH), "--train.epochs", str(TRAIN_EPOCHS),
            "--train.model_path", str(root / "trial_model"),
            "--sweep.checkpoint_file", str(root / "sweep.json"),
            "--sweep.best_model_dir", str(root / "best"), "--sweep.test_runs", "1",
            "--sweep.f1_threshold", "-1"]
    for key, value in DEPLOYED.items():
        argv += [f"--model.{key}", str(value)]
    counters = _train_counters()
    clips = np.random.RandomState(190).rand(SWEEP_PROBE_CLIPS, T, H, W, 3).astype(np.float32)
    probes, trials = {}, []
    evaluate = Trainer.evaluate

    def probed(self, state, *args, **kwargs):
        # The trial's own trained model on the probe clips; these launches
        # are not the trial's.
        metrics = evaluate(self, state, *args, **kwargs)
        before = {n: fn.launches for n, fn in counters.items()}
        probes[self.cfg.model.rnn_type] = classify_videos(state.model, clips,
                                                          batch_size=len(clips))
        for n, fn in counters.items():
            fn.launches = before[n]
        return metrics

    t0 = time.perf_counter()
    with mock.patch.object(sweep_main, "SweepRunner", _sweep_guard(torch, trials)), \
            mock.patch.object(Trainer, "evaluate", probed):
        rc, text = _sweep_main(torch, lambda: sweep_main.main(argv))
    grid_s = time.perf_counter() - t0
    _sweep_hold_trials("grid", trials)
    n_test = int(round(TRAIN_SAMPLES * 0.2))
    steps = TRAIN_EPOCHS * -(-(TRAIN_SAMPLES - n_test) // TRAIN_BATCH)
    for r, rnn in zip(trials, SWEEP_SPACE["model.rnn_type"]):
        want = _expected_train_launches({**DEPLOYED, "rnn_type": rnn},
                                        steps + -(-n_test // TRAIN_BATCH), steps)
        if r["launches"] != want:
            raise AssertionError(f"grid trial {rnn}: launches {r['launches']} != {want}")
    extract_s = [float(s) for s in re.findall(r"feature_cache: extracted .* in ([\d.]+)s", text)]
    entries = SweepStore(str(root / "sweep.json")).load()
    recorded = [e["config"]["model.rnn_type"] for e in entries]
    if rc != 0 or recorded != SWEEP_SPACE["model.rnn_type"] or len(trials) != 3 \
            or len(extract_s) != 3 or "Best result: {" not in text:
        raise AssertionError(f"grid: rc {rc}, {len(trials)} trials, store {entries}")
    print(f"sweep grid: {grid_s:.2f} s for 3 trials; feature extraction {extract_s} s; "
          f"launches held to the steps ({steps} train steps, "
          f"{steps + -(-n_test // TRAIN_BATCH)} forwards a trial)")

    # the same argv again: every configuration skipped
    before = (root / "sweep.json").read_bytes()
    for fn in counters.values():
        fn.launches = 0
    with mock.patch.object(sweep_main, "SweepRunner", _sweep_guard(torch, trials)):
        rc, again = _sweep_main(torch, lambda: sweep_main.main(argv))
    launched = _nonzero({n: fn.launches for n, fn in counters.items()})
    skipped = again.count("Skipping completed config")
    if rc != 0 or skipped != 3 or len(trials) != 3 or launched \
            or (root / "sweep.json").read_bytes() != before or (root / "sweep.jsonl").exists():
        raise AssertionError(f"grid rerun: rc {rc}, {skipped} skipped, {len(trials)} trials, "
                             f"launches {launched}, store changed")
    print("sweep grid rerun: 3 configurations skipped, no launch, store byte-equal")

    # (b) each best model serves as its trial's model did
    served = {}
    for e in entries:
        rnn = e["config"]["model.rnn_type"]
        model, _, _ = load_model(str(root / "best" / e["best_model_filename"]))
        got = classify_videos(model, clips, batch_size=len(clips))
        served[rnn] = float(np.max(np.abs(got - probes[rnn])))
        del model
        if not served[rnn] <= SWEEP_TOL:
            raise AssertionError(f"best model {rnn}: {served[rnn]} from the trial's model")
    print(f"sweep best models: {SWEEP_PROBE_CLIPS} clips each within {served} of the trials' "
          f"own models (tolerance {SWEEP_TOL})")
    return {"grid_s": grid_s, "extract_s": extract_s, "served_max_abs_err": served,
            "trials": [{k: v for k, v in r.items() if k != "launches"} for r in trials],
            "launches": {r["trial"]: _nonzero(r["launches"]) for r in trials}}


def _sweep_child(torch, root: Path, here: Path) -> dict:
    """(c) one trial in the subprocess mode: a ``python -m vct_torch.train``
    child on the card, its metric block scraped; the log holds its output."""
    import os

    from vct_torch.core.config import Config
    from vct_torch.core.metrics_contract import extract_metrics
    from vct_torch.sweep.runner import SweepRunner
    from vct_torch.sweep.store import SweepStore

    cfg = Config().replace(**{
        **{f"model.{k}": str(v) for k, v in DEPLOYED.items()}, **SWEEP_CHILD,
        "data.synthetic": "true", "train.model_path": str(root / "child_model"),
        "sweep.log_file": str(root / "child.log"),
        "sweep.checkpoint_file": str(root / "child.json"),
        "sweep.best_model_dir": str(root / "child_best"), "sweep.f1_threshold": "-1"})
    scraped = []

    class Child(SweepRunner):
        def _train_subprocess(self, cfg):
            scraped.append(super()._train_subprocess(cfg))
            return scraped[-1]

    runner = Child(cfg, store=SweepStore(cfg.sweep.checkpoint_file), use_subprocess=True)
    t0 = time.perf_counter()
    path = os.pathsep.join(filter(None, [str(here), os.environ.get("PYTHONPATH")]))
    with mock.patch.dict(os.environ, {"PYTHONPATH": path}):
        f1, name = runner.run_training({"model.rnn_type": "mamba"}, test_runs=1)
    secs = time.perf_counter() - t0
    log = (root / "child.log").read_text()
    printed = extract_metrics(log)
    if not scraped or dataclasses.asdict(scraped[0]) != dataclasses.asdict(printed) \
            or "Epoch 1/1" not in log or "Error Output" in log or name is None \
            or runner.store.load()[0]["metrics"] != printed.to_dict():
        raise AssertionError(f"subprocess trial: scraped {scraped}, log:\n{log}")
    print(f"sweep subprocess trial: {secs:.2f} s; the scraped metrics are the child's "
          f"(F1 {printed.f1}, accuracy {printed.accuracy}); {len(log)} bytes of log")
    return {"subprocess_s": secs, "subprocess_f1": printed.f1}


def _sweep_small(torch, root: Path) -> dict:
    """(d) the rehearsal's TPE sweep in process (``--trials 8 --epochs 3``)
    and the genetic algorithm (population 4) on the same data, stopped after
    one generation and resumed from its checkpoint to two; the journals,
    the compaction and the resume checked; then one trial streamed from the
    same clip cache. Every trial guarded."""
    from vct_torch.data.ingest import load_or_build_dataset
    from vct_torch.sweep import runner as sweep_runner
    from vct_torch.sweep.store import SweepStore
    from vct_torch.sweep.strategies import genetic_algorithm
    from vct_torch.tools import sweep_rehearsal

    out = root / "rehearsal"
    tpe, ga = [], []
    t0 = time.perf_counter()
    with mock.patch.object(sweep_runner, "SweepRunner", _sweep_guard(torch, tpe)):
        summary, text = _sweep_main(torch, lambda: sweep_rehearsal.main(
            ["--trials", str(SWEEP_TPE_TRIALS), "--epochs", str(SWEEP_SMALL_EPOCHS),
             "--out", str(out)]))
    tpe_s = time.perf_counter() - t0
    _sweep_hold_trials("tpe", tpe)
    if json.loads(text.strip().splitlines()[-1]) != summary:
        raise AssertionError(f"tpe: the last line is not the summary {summary}")
    journal = (out / "tpe_trials.json").read_text().splitlines()
    canonical = json.loads((out / "checkpoint.json").read_text())
    if len(tpe) != SWEEP_TPE_TRIALS or len(journal) != SWEEP_TPE_TRIALS \
            or (out / "checkpoint.jsonl").exists() or len(canonical) != summary["store_entries"] \
            or summary["journal_lines_before_compaction"] != summary["store_entries"]:
        raise AssertionError(f"tpe: {len(tpe)} trials, {len(journal)} journal lines, "
                             f"summary {summary}")
    print(f"sweep tpe: {tpe_s:.2f} s, summary {summary}")

    # Every GA trial is recorded (threshold -1): the journal, then the compaction.
    cfg = sweep_rehearsal.rehearsal_config(str(out), SWEEP_SMALL_EPOCHS).replace(**{
        "sweep.checkpoint_file": str(out / "ga.json"), "sweep.f1_threshold": "-1"})
    data = load_or_build_dataset(cfg)
    ckpt = str(out / "ga_checkpoint.json")
    Guarded = _sweep_guard(torch, ga)

    def genetic(generations: int) -> str:
        """The GA to ``generations`` in a new runner; its stdout."""
        runner = Guarded(cfg, store=SweepStore(cfg.sweep.checkpoint_file), data=data)
        return _sweep_main(torch, lambda: genetic_algorithm(
            runner, sweep_rehearsal.SPACE, population_size=SWEEP_GA_POPULATION,
            generations=generations, seed=0, checkpoint_path=ckpt))[1]

    t0 = time.perf_counter()
    genetic(SWEEP_GA_GENERATIONS - 1)
    stopped = json.loads(Path(ckpt).read_text())
    n_first = len(ga)
    resumed = genetic(SWEEP_GA_GENERATIONS)
    ga_s = time.perf_counter() - t0
    _sweep_hold_trials("genetic", ga)
    saved = json.loads(Path(ckpt).read_text())
    store = SweepStore(cfg.sweep.checkpoint_file)
    journal = Path(store.journal_path).read_text().splitlines()
    entries = store.load()
    store.compact()
    compacted = json.loads(Path(store.path).read_text())
    want_first = SWEEP_GA_POPULATION * SWEEP_GA_GENERATIONS
    if n_first != want_first or len(ga) != want_first + SWEEP_GA_POPULATION \
            or stopped["generation"] != SWEEP_GA_GENERATIONS - 2 \
            or saved["generation"] != SWEEP_GA_GENERATIONS - 1 \
            or f"Resuming GA from generation {SWEEP_GA_GENERATIONS - 1}" not in resumed \
            or saved["rng_state"] == stopped["rng_state"] or len(journal) != len(ga) \
            or compacted != entries or Path(store.journal_path).exists():
        raise AssertionError(f"genetic: {n_first} then {len(ga) - n_first} trials, "
                             f"generations {stopped['generation']} then {saved['generation']}, "
                             f"{len(journal)} journal lines, {len(compacted)} compacted")
    print(f"sweep genetic: {ga_s:.2f} s, {n_first} trials to generation "
          f"{stopped['generation']}, resumed from its checkpoint: {len(ga) - n_first} more to "
          f"generation {saved['generation']}; hall of fame {saved['hall_of_fame']}; "
          f"{len(journal)} journal lines compacted into {len(compacted)} entries")

    # one trial streamed out of the same clip cache (data.stream)
    streamed = []
    stream_cfg = cfg.replace(**{"data.stream": "true",
                                "sweep.checkpoint_file": str(out / "stream.json")})
    runner = _sweep_guard(torch, streamed)(stream_cfg,
                                           store=SweepStore(stream_cfg.sweep.checkpoint_file))
    _, text = _sweep_main(torch, lambda: runner.run_training({}, test_runs=1))
    _sweep_hold_trials("streamed", streamed)
    if "(streaming from" not in text or len(runner.store.load()) != 1:
        raise AssertionError("streamed trial: no stream line or no store entry")
    return {"tpe_s": tpe_s, "tpe_summary": summary, "ga_s": ga_s, "ga_trials": len(ga),
            "streamed_s": streamed[0]["s"]}


def _sweep_path(torch, gpu, root: Path, here: Path) -> None:
    """Phase 19: sweeps. (a) the grid at full width, launches held, the rerun
    skipped; (b) the best models served; (c) a subprocess trial; (d) TPE and
    the genetic algorithm on the rehearsal's configuration, small."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    root.mkdir()
    grid = _sweep_grid(torch, root)
    child = _sweep_child(torch, root, here)
    small = _sweep_small(torch, root)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(json.dumps({"sweep": {**grid, **child, **small, "phase_s": secs}, "gpu": gpu}))
    print(f"sweep phase: {secs:.1f} s")


# The mesh phase: training and serving across ranks and replicas
# (vct_torch.parallel). The card's machine has one H100, so the data and
# model axes run as (a) a world of one rank over NCCL, (b) two ranks sharing
# the card over gloo (gloo takes CUDA tensors for all_reduce, the only
# collective the port's mesh uses), and (c) two serving replicas on cuda:0;
# (d) the multichip dryrun over NCCL needs more than one card.
MESH_STEPS = 3
MESH_BATCH = 32
MESH_TOL_ONE = 1e-6  # the mesh path in a world of one against the plain Trainer
MESH_TOL_RANKS = 1e-5  # two ranks against (a)
# The deployed optimizer, Adam at lr 1e-4, and beside it SGD at lr 1e-3, a
# step the loss falls under, whose three steps hold every parameter with no
# noise floor. Adam's step is about lr * sign(g) where |g| >> eps: where a
# gradient lies within its rounding of zero, the sign follows the order the
# ranks sum in (two ranks' losses parted from (a)'s by 2.6e-5 and 7.0e-5 at
# steps 2 and 3 under Adam, PERF.md §6), so Adam is held after its first
# step by the rule of tests/test_torch_multirank.py (``_mesh_compare``).
MESH_OPTIMIZERS = {"adam": {}, "sgd": {"train.optimizer": "sgd", "train.learning_rate": "1e-3"}}
MESH_NOISE = 1e-4
MESH_SERVE_TOL = 1e-5
MESH_SERVE_BATCH = 8
MESH_GRIDS = ((2, 1), (1, 2))  # (data, model) of the two-rank world


def _mesh_cfg(optimizer: str):
    from vct_torch.core.config import Config

    return Config().replace(**{
        "data.sequence_length": str(T), "data.img_height": str(H), "data.img_width": str(W),
        "train.batch_size": str(MESH_BATCH), "model.compute_dtype": "bfloat16",
        **MESH_OPTIMIZERS[optimizer], **{f"model.{k}": str(v) for k, v in DEPLOYED.items()}})


def _mesh_data(root: Path):
    data = np.load(root / "mesh_data.npz")
    return data["x"], data["y"]


def _mesh_steps(torch, trainer, x, y) -> dict:
    """MESH_STEPS train steps on the global batch (x, y) at once
    (``_mesh_stepper``'s results)."""
    steps = _mesh_stepper(torch, trainer, x, y)
    for _ in range(MESH_STEPS):
        next(steps)
    return next(steps)


def _param_diffs(got: dict, want: dict, tol: float, noisy_of=None) -> dict:
    """Each parameter's elementwise difference, which elements lie beyond
    ``tol`` (absolute plus relative) and, with ``noisy_of`` (name ->
    gradient), which lie under MESH_NOISE of their gradient's largest."""
    out = {}
    for name, b in want.items():
        err = (got[name] - b).abs()
        noisy = (noisy_of[name].abs() < MESH_NOISE * noisy_of[name].abs().max()
                 if noisy_of is not None else err < 0)
        out[name] = (err, err > tol + tol * b.abs(), noisy)
    return out


def _mesh_compare(label: str, got: dict, want: dict, tol: float, losses_held: int,
                  adam_lr: float = 0.0) -> dict:
    """The first ``losses_held`` losses within ``tol`` (relative) and every
    parameter element after the last step within ``tol`` (absolute and
    relative); returns the largest differences beside the parameters'
    largest change over the steps in ``want``. Later losses are printed,
    not held: a loss read after an update amplifies the parameters'
    difference (on the CPU 1.2e-7 in the parameters gave 2.0e-6 in the third
    loss), so the parameters are what is held.

    Under Adam (``adam_lr``) the rule of tests/test_torch_multirank.py holds
    the parameters after the first step: within ``tol``, except the elements
    whose first gradient in ``want`` lies below MESH_NOISE of its tensor's
    largest, held within 2 ``adam_lr``. Those elements' differences change
    the later gradients, which Adam's normalised step turns into differences
    of up to 2 ``adam_lr`` a step anywhere: after the last step every
    element is held within that reach, and those beyond ``tol`` counted."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    if max(rel[:losses_held]) > tol:
        raise AssertionError(f"{label}: losses {got['losses']} vs {want['losses']}")
    out = {"limit": tol, "largest_param_change": want["largest_change"]}
    if adam_lr:
        first_limit = 2 * adam_lr + tol
        n_noisy, worst, worst_noisy = 0, 0.0, 0.0
        diffs = _param_diffs(got["first_params"], want["first_params"], tol,
                             want["first_grads"])
        for name, (err, beyond, noisy) in diffs.items():
            if bool((beyond & ~noisy).any()) or bool((err[noisy] > first_limit).any()):
                raise AssertionError(f"{label}: {name} differs by {float(err.max())} after "
                                     f"step 1 (limit {tol}, {first_limit} under the noise floor)")
            n_noisy += int(noisy.sum())
            worst = max(worst, float(err[~noisy].max()) if bool((~noisy).any()) else 0.0)
            worst_noisy = max(worst_noisy, float(err[noisy].max()) if bool(noisy.any()) else 0.0)
        n_all = sum(err.numel() for err, _, _ in diffs.values())
        out["first_step"] = {"max_abs_param_diff": worst, "noise_floor_share": n_noisy / n_all,
                             "max_abs_diff_under_noise_floor": worst_noisy,
                             "noise_floor_limit": first_limit}
    reach = 2 * adam_lr * len(want["losses"]) + tol if adam_lr else None
    worst, n_beyond, n_all = 0.0, 0, 0
    for name, (err, beyond, _) in _param_diffs(got["params"], want["params"], tol).items():
        worst = max(worst, float(err.max()))
        n_beyond, n_all = n_beyond + int(beyond.sum()), n_all + err.numel()
        if (bool((err > reach).any()) if adam_lr else bool(beyond.any())):
            raise AssertionError(f"{label}: {name} differs by {float(err.max())} "
                                 f"(limit {reach if adam_lr else tol})")
    out.update({"max_abs_param_diff": worst, "beyond_limit_share": n_beyond / n_all,
                "adam_reach": reach, "loss_rel_diff_by_step": rel})
    return out


def _mesh_rank(torch, root: Path) -> None:
    """One rank of the two-rank world (b): both ranks on cuda:0 over gloo,
    each optimizer of MESH_OPTIMIZERS at each grid of MESH_GRIDS in turn;
    rank 0 writes the results."""
    from vct_torch.parallel import multihost
    from vct_torch.parallel.mesh import make_mesh
    from vct_torch.train.engine import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(device="cuda:0", backend="gloo")
    x, y = _mesh_data(root)
    results = {}
    for opt in MESH_OPTIMIZERS:
        cfg = _mesh_cfg(opt)
        names = [f"class_{i}" for i in range(cfg.model.num_classes)]
        for data, model in MESH_GRIDS:
            key = f"{opt}_{data}x{model}"
            trainer = Trainer(cfg, names, mesh=make_mesh(data=data, model=model))
            results[key] = _mesh_steps(torch, trainer, x, y)
            results[key]["sharded"] = len(trainer._specs or {})
            del trainer
            torch.cuda.empty_cache()
    launches = [None] * 2
    torch.distributed.all_gather_object(
        launches, {k: v["launches"] for k, v in results.items()})
    if multihost.is_primary():
        for k in results:
            results[k]["launches_by_rank"] = [r[k] for r in launches]
        torch.save(results, root / "mesh_ranks.pt")
    multihost.shutdown()


def _mesh_serving(torch, gpu, root: Path) -> dict:
    """(c): phase 15's checkpoint served by two replicas on cuda:0 on raw
    clips selected by SAD on the card (K1, K3), through classify_videos and
    a data_parallel=2 artifact, each held against the one-device path at a
    replica's rows a forward (half the chunk), K3's launches counted a
    replica. The one-device path at the whole chunk is reported beside it,
    not held: the bf16 backbone's convolutions round differently at
    another batch size (6.5e-4 between B=1 and B=32, PERF.md §6)."""
    from vct_torch.ops import pair_scores as k1
    from vct_torch.ops import selective_scan as k3
    from vct_torch.parallel.mesh import make_mesh
    from vct_torch.serve import aot, deployment

    ck = str(root / "ck")
    model, class_names, cfg = deployment.load_model(ck)
    seq_len = cfg.data.sequence_length
    rng = np.random.RandomState(200)
    lengths = np.array([FILES_SERVED[i % len(FILES_SERVED)] for i in range(2 * MESH_SERVE_BATCH)],
                       np.int32)
    raw = np.zeros((len(lengths), AOT_RAW_LEN, H, W, 3), np.uint8)
    for i, n in enumerate(lengths):
        raw[i, :n] = rng.randint(0, 256, (n, H, W, 3), dtype=np.uint8)
        raw[i, n:] = raw[i, n - 1]
    k1.pair_scores.launches = 0
    clips = deployment.sample_decoded_clips([r[:n] for r, n in zip(raw, lengths)], "sad",
                                            seq_len).cpu().numpy()
    k1_eager = k1.pair_scores.launches
    mesh = make_mesh(["cuda:0", "cuda:0"], model=1)
    replicas = deployment.mesh_replicas(model, mesh)
    per_replica = [0, 0]

    def count(i):
        def pre(mod, args):
            mod._k3_before = k3.selective_scan.launches

        def post(mod, args, out):
            per_replica[i] += k3.selective_scan.launches - mod._k3_before
        return pre, post

    hooks = []
    for i, r in enumerate(replicas):
        pre, post = count(i)
        hooks += [r.register_forward_pre_hook(pre), r.register_forward_hook(post)]
    rows = MESH_SERVE_BATCH // 2  # a replica's rows a forward
    whole = deployment.classify_videos(model, clips, batch_size=MESH_SERVE_BATCH)
    k3.selective_scan.launches = 0
    one = deployment.classify_videos(model, clips, batch_size=rows)
    k3_one = k3.selective_scan.launches
    per_replica[:] = [0, 0]
    two = deployment.classify_videos(model, clips, batch_size=MESH_SERVE_BATCH, mesh=mesh)
    for h in hooks:
        h.remove()
    err = float(np.abs(two - one).max())
    blocks = cfg.model.rnn_layer
    chunks = len(clips) // MESH_SERVE_BATCH
    if (err > MESH_SERVE_TOL or per_replica != [chunks * blocks] * 2
            or k3_one != 2 * chunks * blocks):
        raise AssertionError(f"mesh serving: two replicas {err} from one device, K3 launches "
                             f"a replica {per_replica}, one device {k3_one}")

    # the data_parallel=2 artifact, raw SAD clips, both replicas on cuda:0
    art = root / "mesh_dp2.vctaot"
    t0 = time.perf_counter()
    aot.export_from_checkpoint(ck, str(art), batch_sizes=(MESH_SERVE_BATCH,), data_parallel=2,
                               device_sampling="sad", raw_len=AOT_RAW_LEN,
                               devices=["cuda:0", "cuda:0"])
    export_s = time.perf_counter() - t0
    sv = aot.AotServable.load(str(art), devices=["cuda:0", "cuda:0"])
    fn = sv._fns[MESH_SERVE_BATCH]
    art_launches = [{"pair_scores": 0, "selective_scan": 0} for _ in fn.modules]

    def counted(i, module):
        def call(*args):
            before = (k1.pair_scores.launches, k3.selective_scan.launches)
            out = module(*args)
            art_launches[i]["pair_scores"] += k1.pair_scores.launches - before[0]
            art_launches[i]["selective_scan"] += k3.selective_scan.launches - before[1]
            return out
        return call

    fn.modules = [counted(i, m) for i, m in enumerate(fn.modules)]
    probs = sv.classify_raw(raw, lengths)
    art_err = float(np.abs(probs - one).max())
    want_art = {"pair_scores": chunks, "selective_scan": chunks * blocks}
    if art_err > MESH_SERVE_TOL or art_launches != [want_art] * 2:
        raise AssertionError(f"data_parallel=2 artifact: {art_err} from one device, launches "
                             f"a replica {art_launches} != {want_art}")
    out = {"clips": len(clips), "replicas": 2, "rows_a_forward": rows,
           "classify_max_abs_err": err,
           "vs_one_device_at_the_whole_chunk": float(np.abs(two - whole).max()),
           "k3_launches_per_replica": per_replica, "k1_launches_sampling": k1_eager,
           "artifact_max_abs_err": art_err, "artifact_launches_per_replica": art_launches,
           "artifact_export_s": export_s, "gpu": gpu}
    del model, replicas, sv
    torch.cuda.empty_cache()
    return out


def _mesh_path(torch, gpu, root: Path, here: Path) -> None:
    """Phase 20: (a) the deployed config's train step through a world of one
    rank over NCCL against the plain Trainer, in turns; (b) two ranks on the
    card over gloo at (data 2, model 1) and (data 1, model 2) against (a);
    (c) two serving replicas on cuda:0 (``_mesh_serving``); (d) the
    multichip dryrun over NCCL when there is more than one card."""
    from vct_torch.ops import _build
    from vct_torch.parallel import multihost
    from vct_torch.parallel.mesh import make_mesh
    from vct_torch.tools.dryrun import dryrun_multichip, run_world
    from vct_torch.train.engine import Trainer
    from vct_torch.utils.cpumesh import free_port

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    cfgs = {opt: _mesh_cfg(opt) for opt in MESH_OPTIMIZERS}
    n_classes, blocks = cfgs["adam"].model.num_classes, cfgs["adam"].model.rnn_layer
    rng = np.random.RandomState(190)
    x = rng.randint(0, 256, (MESH_BATCH, T, H, W, 3), dtype=np.uint8)
    y = rng.randint(0, n_classes, MESH_BATCH).astype(np.int64)
    np.savez(root / "mesh_data.npz", x=x, y=y)
    names = [f"class_{i}" for i in range(n_classes)]
    want_k3 = {"selective_scan": MESH_STEPS * blocks, "selective_scan_bwd": MESH_STEPS * blocks}
    adam_lr = {opt: cfg.train.learning_rate if cfg.train.optimizer == "adam" else 0.0
               for opt, cfg in cfgs.items()}

    # (a) a world of one over NCCL, against the plain Trainer, in turns
    summary, plains = {}, {}
    multihost.initialize(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
                         process_id=0, device="cuda:0")
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"world of one: backend {torch.distributed.get_backend()}")
        probe = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(probe)  # one NCCL collective on the card
        if not bool((probe == 1).all()):
            raise AssertionError("NCCL all_reduce over a world of one changed its input")
        for opt, cfg in cfgs.items():
            plain = Trainer(cfg, names, mesh=make_mesh(["cuda:0"]))
            meshed = Trainer(cfg, names, mesh=make_mesh(data=1, model=1))
            if not meshed.mesh.distributed or plain.mesh.distributed:
                raise AssertionError("the mesh Trainer did not take the world's mesh")
            # In turns: plain's step i, then mesh's step i (MESH_STEPS each).
            gens = {"plain": _mesh_stepper(torch, plain, x, y, grads=True),
                    "mesh": _mesh_stepper(torch, meshed, x, y)}
            for _ in range(MESH_STEPS):
                for k in ("plain", "mesh"):
                    next(gens[k])
            states = {k: next(g) for k, g in gens.items()}
            del plain, meshed, gens
            torch.cuda.empty_cache()
            a_err = _mesh_compare(f"{opt}: world of one vs plain", states["mesh"],
                                  states["plain"], MESH_TOL_ONE, losses_held=MESH_STEPS,
                                  adam_lr=adam_lr[opt])
            for k in ("plain", "mesh"):
                if states[k]["launches"] != want_k3:
                    raise AssertionError(f"(a) {opt} {k}: K3 launches {states[k]['launches']} "
                                         f"!= {want_k3}")
            plains[opt] = states["plain"]
            summary[f"world_of_one_{opt}"] = {
                "backend": "nccl", "optimizer": opt, "losses": states["mesh"]["losses"],
                "plain_losses": states["plain"]["losses"], **a_err,
                "step_ms": states["mesh"]["step_ms"],
                "plain_step_ms": states["plain"]["step_ms"],
                "k3_launches": states["mesh"]["launches"],
                "plain_k3_launches": states["plain"]["launches"]}
            print(json.dumps({f"mesh_a_{opt}": summary[f"world_of_one_{opt}"], "gpu": gpu}),
                  flush=True)
    finally:
        multihost.shutdown()

    # (b) two ranks on the card over gloo, after (a): its step times are alone.
    t_world = time.perf_counter()
    run_world(2, [str(here / "chip_smoke.py"), "--mesh-rank", str(root)], device="cuda")
    world_s = time.perf_counter() - t_world
    got = torch.load(root / "mesh_ranks.pt", weights_only=False)
    for key, res in got.items():
        opt, grid = key.split("_")
        err = _mesh_compare(f"two ranks {key} vs (a)", res, plains[opt], MESH_TOL_RANKS,
                            losses_held=1, adam_lr=adam_lr[opt])
        per_rank = res["launches_by_rank"]
        data = int(grid.split("x")[0])
        if any(r != want_k3 for r in per_rank):
            raise AssertionError(f"(b) {key}: K3 launches by rank {per_rank} != {want_k3}")
        summary[f"two_ranks_{key}"] = {
            "backend": "gloo", "device": "cuda:0 (both ranks)", "optimizer": opt,
            "losses": res["losses"], **{f"{k}_vs_a": v for k, v in err.items()},
            "step_ms_rank0": res["step_ms"], "k3_launches_by_rank": per_rank,
            "sharded_params": res["sharded"], "rows_a_rank": MESH_BATCH // data}
        print(json.dumps({f"mesh_b_{key}": summary[f"two_ranks_{key}"], "gpu": gpu}),
              flush=True)
    summary["two_rank_world_s"] = world_s

    # (c) two serving replicas on cuda:0
    _build.load_kernels()
    summary["replicas"] = _mesh_serving(torch, gpu, root)

    # (d) NCCL across cards
    n = torch.cuda.device_count()
    if n > 1:
        summary["multichip"] = dryrun_multichip(n, "cuda")
    else:
        summary["multichip"] = (f"not run: {n} card; NCCL across cards ran on no "
                                "machine of this check")
    summary["gpu"] = gpu
    print(json.dumps({"mesh": summary}))
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s ({gpu})")


def _mesh_stepper(torch, trainer, x, y, grads: bool = False):
    """A generator: one train step on the global batch (x, y) a ``next``,
    MESH_STEPS of them, then the run's results: the loss of each step, each
    trained parameter's whole value after the first and the last step, the
    largest change of a parameter element over the steps, the K3 launches,
    each step's milliseconds (host clock around a synchronized step) and,
    with ``grads`` (an unsharded trainer), each parameter's gradient at the
    first step."""
    from vct_torch.ops import selective_scan as k3
    from vct_torch.train.checkpoint import gather_state_dict

    state = trainer.init_state()
    trained = set(trainer._trained_names)
    start = {k: v.float().cpu().clone() for k, v in gather_state_dict(state).items()
             if k in trained}
    mask = np.ones(len(x), np.float32)
    losses, ms = [], []
    first_grads = None
    launches = {"selective_scan": 0, "selective_scan_bwd": 0}
    for _ in range(MESH_STEPS):
        batch = trainer._put_global(x, y, mask)
        before = (k3.selective_scan.launches, k3.selective_scan_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = trainer._train_step(state, *batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches["selective_scan"] += k3.selective_scan.launches - before[0]
        launches["selective_scan_bwd"] += k3.selective_scan_bwd.launches - before[1]
        losses.append(float(loss))
        if len(losses) == 1:
            first = {k: v.float().cpu().clone() for k, v in gather_state_dict(state).items()
                     if k in trained}
            if grads:
                first_grads = {name: p.grad.float().cpu() if p.grad is not None
                               else torch.zeros(p.shape)
                               for name, p in zip(trainer._trained_names, trainer._trained)}
        yield None
    params = {k: v.float().cpu() for k, v in gather_state_dict(state).items() if k in trained}
    change = max(float((params[k] - start[k]).abs().max()) for k in params)
    yield {"losses": losses, "params": params, "first_params": first, "launches": launches,
           "step_ms": ms, "largest_change": change, "first_grads": first_grads}


# Phase 21, finetune and fold: the deployed configuration at full width
# (DEPLOYED, resnet50 in bf16, 3 Mamba blocks, T=60, 80x80, B=32 seeded
# uint8 clips, dropout 0.25, Adam at lr 1e-4) with its backbone trained.
FT_STEPS = 3
FT_BATCH = 32
# The folded stem against x / 255, logits' largest difference. In bf16 one
# path rounds the stem's inputs and the other its weights, and the two
# roundings run through the whole backbone: the difference is of the order
# of the plain model's own bf16 error against f32, measured in the same run,
# and held at FT_FOLD_BF16_OF_PLAIN times it; far above a batch size's
# (6.48e-4 to 8.68e-4 at B=1 against B=32, PERF.md §6; cited beside it, not
# measured here). In f32 with TF32 off only the fold's own rounding is left.
FT_FOLD_BF16_OF_PLAIN = 3.0
FT_FOLD_TOL_F32 = 1e-4
# remat on against off, every parameter after FT_STEPS: of each tensor's
# largest change over the steps.
FT_PARAM_TOL = 1e-5
FT_FREEZE = "conv1,bn1,layer1,layer2,layer3"


def _ft_cfg(**model):
    from vct_torch.core.config import Config

    return Config().replace(**{
        "data.sequence_length": str(T), "data.img_height": str(H), "data.img_width": str(W),
        "train.batch_size": str(FT_BATCH), "model.compute_dtype": "bfloat16",
        **{f"model.{k}": str(v) for k, v in {**DEPLOYED, **model}.items()}})


def _ft_stepper(torch, trainer, x, y):
    """A generator: one train step on (x, y) a ``next``, FT_STEPS of them,
    then the run's results: each step's loss, milliseconds (host clock
    around a synchronized step), peak ``max_memory_allocated`` (after
    ``reset_peak_memory_stats``) and that peak above the memory allocated
    when the step began, the backbone's forward calls (a pre-hook: a
    rematerialising backward calls it again, and stops its recompute before
    the forward returns), K3's launches, and every trained parameter before
    and after the steps."""
    from vct_torch.ops import selective_scan as k3

    state = trainer.init_state()
    calls = []
    hook = trainer.model.cnn_backbone.register_forward_pre_hook(lambda *_: calls.append(1))
    start = {n: p.detach().float().cpu().clone() for n, p in
             zip(trainer._trained_names, trainer._trained)}
    mask = np.ones(len(x), np.float32)
    out = {"losses": [], "step_ms": [], "peak_bytes": [], "peak_rise_bytes": [],
           "backbone_calls": [], "launches": {"selective_scan": 0, "selective_scan_bwd": 0}}
    for _ in range(FT_STEPS):
        batch = trainer._put_batch(x, y, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = (k3.selective_scan.launches, k3.selective_scan_bwd.launches, len(calls))
        t0 = time.perf_counter()
        loss, _, _ = trainer._train_step(state, *batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        out["peak_bytes"].append(peak)
        out["peak_rise_bytes"].append(peak - base)
        out["launches"]["selective_scan"] += k3.selective_scan.launches - before[0]
        out["launches"]["selective_scan_bwd"] += k3.selective_scan_bwd.launches - before[1]
        out["backbone_calls"].append(len(calls) - before[2])
        out["losses"].append(float(loss))
        yield None
    hook.remove()
    out["start"] = start
    out["params"] = {n: p.detach().float().cpu() for n, p in
                     zip(trainer._trained_names, trainer._trained)}
    yield out


def _fold_limit(dtype: str, plain_bf16_err: float) -> float:
    """The fold's limit: FT_FOLD_TOL_F32 in f32; in bf16 FT_FOLD_BF16_OF_PLAIN
    times the plain model's own bf16 error against its f32 logits."""
    return FT_FOLD_TOL_F32 if dtype == "float32" else FT_FOLD_BF16_OF_PLAIN * plain_bf16_err


def _fold_hold(label: str, diff: float, limit: float) -> None:
    """The folded stem's logits against x / 255's within ``limit``."""
    if not diff <= limit:
        raise AssertionError(f"{label}: folded logits {diff} from x / 255's (limit {limit})")


def _finetune_hold(off: dict, on: dict, want_k3: dict) -> dict:
    """``model.remat_backbone`` on against off, FT_STEPS finetune steps
    each: the losses bit-equal, the backbone called once a step without
    remat and twice with it (the recompute), K3's launches ``want_k3`` in
    each run, and every parameter after the steps within FT_PARAM_TOL of
    its tensor's largest change in the run without remat. Returns the
    largest difference beside its limit."""
    if on["losses"] != off["losses"]:
        raise AssertionError(f"remat losses {on['losses']} != {off['losses']} without it")
    if off["backbone_calls"] != [1] * FT_STEPS or on["backbone_calls"] != [2] * FT_STEPS:
        raise AssertionError(f"backbone calls a step: {off['backbone_calls']} without remat, "
                             f"{on['backbone_calls']} with it (want 1 and 2: the recompute)")
    for label, run in (("without remat", off), ("with remat", on)):
        if run["launches"] != want_k3:
            raise AssertionError(f"{label}: K3 launches {run['launches']} != {want_k3}")
    worst, worst_ratio, largest = 0.0, 0.0, 0.0
    for name, p in off["params"].items():
        change = float((p - off["start"][name]).abs().max())
        err = float((on["params"][name] - p).abs().max())
        if err > FT_PARAM_TOL * change:
            raise AssertionError(f"remat: {name} differs by {err} after {FT_STEPS} steps "
                                 f"(limit {FT_PARAM_TOL} x its largest change {change})")
        worst, largest = max(worst, err), max(largest, change)
        worst_ratio = max(worst_ratio, err / change if change else 0.0)
    return {"max_abs_param_diff": worst, "max_diff_over_change": worst_ratio,
            "largest_change": largest, "limit_of_change": FT_PARAM_TOL}


def _freeze_hold(moved: dict) -> list:
    """After a ``freeze_until`` step: only layer4's backbone parameters
    moved, and some did. ``moved``: {parameter name: moved}. Returns the
    backbone parameters that moved."""
    backbone = [n for n, m in moved.items() if m and n.startswith("cnn_backbone.")]
    wrong = [n for n in backbone if not n.startswith("cnn_backbone.layer4")]
    if wrong or not backbone:
        raise AssertionError(f"freeze_until {FT_FREEZE!r}: moved {wrong or 'no layer4 parameter'}")
    return backbone


def _finetune_path(torch, gpu) -> None:
    """Phase 21: (a) the stem fold: raw uint8 clips cast to the compute
    dtype into a model whose stem holds the 1/255, against x / 255 into the
    plain one, in bf16 and in f32 (TF32 off), both forwards timed in turns;
    (b) FT_STEPS frozen steps and ``finetune`` steps with ``remat_backbone``
    off and on, in turns, under cudnn's deterministic algorithms;
    (c) two steps with ``freeze_until``, held after each."""
    import copy

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.models.backbones.port import fold_input_scale_into_stem
    from vct_torch.train.engine import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = np.random.RandomState(210)
    x = rng.randint(0, 256, (FT_BATCH, T, H, W, 3), dtype=np.uint8)
    xd = torch.from_numpy(x).cuda()
    out = {}

    # (a) the fold
    fold, plain_f32 = {}, None
    for dtype in ("float32", "bfloat16"):
        model = build_model(ModelConfig(**DEPLOYED, compute_dtype=dtype), T, seed=0)
        folded = copy.deepcopy(model)
        folded.cnn_backbone = fold_input_scale_into_stem(model.cnn_backbone, "resnet50")
        plain_fn = lambda: model(xd.float() / 255.0)  # noqa: E731
        fold_fn = lambda: folded(xd)  # noqa: E731
        with torch.inference_mode():
            plain = plain_fn()
            diff = float((fold_fn() - plain).abs().max())
            row = {"max_abs_logit_diff": diff, "max_abs_logit": float(plain.abs().max())}
            if plain_f32 is None:
                plain_f32 = plain.float()
                row["limit"] = _fold_limit(dtype, 0.0)
            else:  # bf16: the plain model's own error, then both forwards in turns
                row["plain_bf16_vs_f32"] = float((plain.float() - plain_f32).abs().max())
                row["limit"] = _fold_limit(dtype, row["plain_bf16_vs_f32"])
                times = {"plain_ms": [], "fold_ms": []}  # plain, fold, fold, plain
                for key in ("plain_ms", "fold_ms", "fold_ms", "plain_ms"):
                    times[key].append(_events_ms(torch, plain_fn if key == "plain_ms"
                                                 else fold_fn, 5, warmup=1))
                row.update(times)
        _fold_hold(f"fold {dtype}", diff, row["limit"])
        fold[dtype] = row
        del model, folded
        torch.cuda.empty_cache()
    out["fold"] = fold
    cited = {"bf16_batch_size_diff": [6.48e-4, 8.68e-4], "source": "PERF.md §6, B=1 against B=32"}
    print(json.dumps({"finetune_fold": fold, "cited_not_measured": cited, "gpu": gpu}), flush=True)

    # (b) the frozen step, finetune with remat off and on, in turns
    n_classes = _ft_cfg().model.num_classes
    y = rng.randint(0, n_classes, FT_BATCH).astype(np.int64)
    names = [f"class_{i}" for i in range(n_classes)]
    want_k3 = {"selective_scan": FT_STEPS * DEPLOYED["rnn_layer"],
               "selective_scan_bwd": FT_STEPS * DEPLOYED["rnn_layer"]}
    cfgs = {"frozen": _ft_cfg(), "finetune": _ft_cfg(finetune="true"),
            "finetune_remat": _ft_cfg(finetune="true", remat_backbone="true")}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gens = {k: _ft_stepper(torch, Trainer(cfg, names), x, y) for k, cfg in cfgs.items()}
        for _ in range(FT_STEPS):
            for g in gens.values():
                next(g)
        runs = {k: next(g) for k, g in gens.items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del gens
    torch.cuda.empty_cache()
    if runs["frozen"]["launches"] != want_k3:
        raise AssertionError(f"frozen: K3 launches {runs['frozen']['launches']} != {want_k3}")
    held = _finetune_hold(runs["finetune"], runs["finetune_remat"], want_k3)
    for key, run in runs.items():
        out[key] = {k: run[k] for k in ("losses", "step_ms", "peak_bytes", "peak_rise_bytes",
                                        "backbone_calls", "launches")}
    out["finetune_remat"].update(held)
    print(json.dumps({"finetune_steps": {k: out[k] for k in ("frozen", "finetune",
                                                             "finetune_remat")},
                      "gpu": gpu}), flush=True)

    # (c) freeze_until: only layer4 of the backbone moves, held after each of
    # two steps (a new trainer's first step carries its warm-up)
    trainer = Trainer(_ft_cfg(finetune="true", freeze_until=FT_FREEZE), names)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state = trainer.init_state()
    batch = trainer._put_batch(x, y, np.ones(FT_BATCH, np.float32))
    step_ms, peaks = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer._train_step(state, *batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        moved = {n: not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters()}
        backbone = _freeze_hold(moved)
    out["freeze_until"] = {"prefixes": FT_FREEZE, "step_ms": step_ms, "peak_bytes": peaks,
                           "backbone_params_moved": len(backbone),
                           "backbone_params": sum(n.startswith("cnn_backbone.") for n in moved)}
    del trainer, state, before
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"finetune_freeze_until": out["freeze_until"], "gpu": gpu}), flush=True)
    print(f"finetune phase: {out['seconds']:.1f} s ({gpu})")

# Phase 22, the LSTM/GRU path at H = 128: the UCF50 LSTM configuration with
# rnn_input_size 32 and hidden_size unset, so H = mult_factor * 32 = 128 by
# vct's own derivation (resolved_hidden_size), the "clusters" design; its
# GRU and bidirectional-GRU variants beside it.
UCF50_H128 = {**{k: v for k, v in UCF50.items() if k != "hidden_size"}, "rnn_input_size": 32}
H128_HEADS = (("lstm", False), ("gru", False), ("gru", True))
H128_STEPS = 3


def _h128_path(torch, gen, gpu) -> dict:
    """For each H128_HEADS head of UCF50_H128 (resnet50 in bf16, dropout 0,
    TF32 off, seeded weights): its designs and plans printed and checked
    ("clusters" forward and backward); one request of four decoded videos
    through ``classify_videos``, K2/K5's launches read around exactly that
    call, and the same clips' logits through the kernels held within 1e-4
    of the plain path's; then H128_STEPS train steps at B = 32 on the
    backbone's features through the kernels, before each the gradient of
    every trained parameter on the kernel path held within BWD_RTOL of its
    largest on the plain path, from the same parameters, and each step's
    forward and backward launches read around it. Returns the launches by
    counter over the phase (the served requests and the train steps)."""
    from vct_torch.core.config import Config
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.serve.deployment import classify_videos, sample_decoded_clips
    from vct_torch.train.engine import Trainer

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _train_counters()
    clips = sample_decoded_clips(_synthetic_videos([30, 75, 121, 200], seed=5), "sad", T_UCF50)
    totals = dict.fromkeys(counters, 0)
    rows = {}
    for rnn_type, bidirectional in H128_HEADS:
        model = {**UCF50_H128, "rnn_type": rnn_type, "bidirectional": bidirectional,
                 "compute_dtype": "bfloat16", "dropout": 0.0}
        head = f"h128 {rnn_type} {'bidir' if bidirectional else 'uni'}"
        cfg = Config().replace(**{"data.sequence_length": str(T_UCF50),
                                  "train.batch_size": str(TRAIN_BATCH),
                                  **{f"model.{k}": str(v) for k, v in model.items()}})
        Hd, n_gates = cfg.model.resolved_hidden_size, 4 if rnn_type == "lstm" else 3
        layers = 1 if bidirectional else cfg.model.rnn_layer
        designs = (rnn_ops.design(T_UCF50, Hd, layers, n_gates),
                   rnn_ops.bwd_design(T_UCF50, Hd, n_gates))
        if Hd != 128 or designs != ("clusters", "clusters"):
            raise AssertionError(f"{head}: H = {Hd}, designs {designs}")
        row = {"H": Hd, "design": designs[0], "bwd_design": designs[1],
               "serve_plan": rnn_ops.plan(len(clips), T_UCF50, Hd, layers, n_gates),
               "train_plan": rnn_ops.plan(TRAIN_BATCH, T_UCF50, Hd, layers, n_gates),
               "train_bwd_plan": rnn_ops.plan(TRAIN_BATCH, T_UCF50, Hd, layers, n_gates, True)}
        trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
        net = trainer.model.eval()

        # --- serving: one request, then its logits kernel vs plain ----------
        for fn in counters.values():
            fn.launches = 0
        probs = classify_videos(net, clips, batch_size=len(clips))
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = _expected_train_launches(model, 1, 0)
        if launches != want:
            raise AssertionError(f"{head}: served launches {launches} != expected {want}")
        if not (np.isfinite(probs).all() and np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)):
            raise AssertionError(f"{head}: bad probabilities {probs}")
        totals = {n: totals[n] + launches[n] for n in totals}
        x = torch.as_tensor(clips).cuda().float()
        torch.backends.cudnn.deterministic = True  # the same conv algorithms on both paths
        with torch.inference_mode():
            logits_k = net(x)
            _set_scan_impl(net, "scan")
            logits_p = net(x)
            _set_scan_impl(net, "pallas")
        torch.backends.cudnn.deterministic = False
        torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
        row["serve_launches"] = _nonzero(launches)
        row["logits_max_abs_err"] = (logits_k - logits_p).abs().max().item()

        # --- training: kernel-path gradients against the plain path's ------
        frames = torch.rand(TRAIN_BATCH, T_UCF50, H, W, 3, generator=gen).cuda()
        with torch.no_grad():
            feats = net(frames, features_only=True)
        trainer._feature_mode = True
        state = trainer.init_state()
        mask = torch.ones(TRAIN_BATCH, device=feats.device)
        names = [n for n, p in net.named_parameters() if p.requires_grad]
        worst, losses = 0.0, []
        want = _expected_train_launches(model, 1, 1)
        for step in range(H128_STEPS):
            labels = torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
            net.train()
            grads = {}
            for impl in ("scan", "pallas"):
                _set_scan_impl(net, impl)
                loss = trainer._loss_fn(net(feats, from_features=True), labels, mask)[0]
                grads[impl] = torch.autograd.grad(loss, trainer._trained, allow_unused=True)
            for n, a, b in zip(names, grads["pallas"], grads["scan"]):
                worst = max(worst, _grads_close(torch, f"{head} step {step} gradient of", [a], [b],
                                                [n])[0])
            for fn in counters.values():
                fn.launches = 0
            losses.append(trainer._train_step(state, feats, labels, mask)[0].item())
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counters.items()}
            if launches != want or not np.isfinite(losses[-1]):
                raise AssertionError(f"{head} step {step}: launches {launches} != expected {want}"
                                     f", loss {losses[-1]}")
            totals = {n: totals[n] + launches[n] for n in totals}
        row.update({"train_steps": H128_STEPS, "losses": losses,
                    "train_launches_a_step": _nonzero(want),
                    "max_grad_err_over_max_grad": worst})
        rows[head] = row
        print(json.dumps({head: row, "gpu": gpu}), flush=True)
        del trainer, net, state, feats
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"H = 128 phase: {len(rows)} heads, designs clusters forward and backward, launches "
          f"{_nonzero(totals)}; {seconds:.1f} s ({gpu})", flush=True)
    return totals



def _bwd_timing(torch, gen, name, dims) -> dict:
    """One backward entry point at the main path's shape: time by events and
    from a CUDA graph, autograd through the plain version (its forward
    included), the bound and, for LSTM/GRU, cuDNN's backward with the same
    weights. cuDNN's layer 0 takes x (B, T, H) through its own W_ih, so
    the library call also forms dx and dW_ih of that projection, two
    (B*T, H) x (H, G*H)-sized products (as much as one layer's dy and dW_ih
    here) that the entry point leaves to its caller."""
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3

    if name == "selective_scan_bwd":
        B, L, D, N = dims
        args = _scan_inputs(torch, gen, B, L, D, N)
        gy = torch.randn(B, L, D, generator=gen).cuda()
        fn = lambda: k3.selective_scan_bwd(*args, gy)  # noqa: E731
        plain = lambda: k3.selective_scan_bwd_ref(*args, gy)  # noqa: E731
        bound, by = _bound_ms(4 * (5 * B * L * D + 4 * B * L * N + 2 * D * N),
                              SCAN_BWD_FLOPS * B * L * D * N)
        device_ms = _graph_ms(torch, fn, 20)
        return {"shape": list(dims), "plan": k3.bwd_plan(B, L, D, N),
                "ms": _events_ms(torch, fn, 20), "device_ms": device_ms,
                "us_per_step": device_ms / L * 1e3, "kernel_launches": _kernels_a_call(torch, fn),
                "plain_ms": _events_ms(torch, plain, 3),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "expf_bound_ms": B * L * D * N / SFU_EXP_PER_S * 1e3}
    cell, kind, _ = name.split("_")
    n_gates = 4 if cell == "lstm" else 3
    B, T_, Hd, L = dims
    L = L if kind == "stack" else 1
    GH, k = n_gates * Hd, Hd ** -0.5
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, max(L, 2))
    w_hh, b_hh, w_ih, b_ih = w_hh[:L], b_hh[:L], w_ih[:L - 1], b_ih[:L - 1]
    gy = torch.randn(B, T_, Hd, generator=gen).cuda()
    if kind == "stack":
        args = (xp, w_hh, b_hh, w_ih, b_ih)
        y, hs, _ = ops._launch(f"{cell}_stack", n_gates, *args, save=True)
        fn = lambda: getattr(ops, name)(*args, hs, y, gy)  # noqa: E731
        plain = lambda: ops.stack_bwd_ref(*args, gy)  # noqa: E731
    else:
        args = (xp, w_hh[0], b_hh[0])
        y, _, _ = ops._launch(f"{cell}_scan", n_gates, *args)
        fn = lambda: getattr(ops, name)(*args, y, gy)  # noqa: E731
        plain = lambda: ops.scan_bwd_ref(*args, gy)  # noqa: E731
    # Bytes: xp0, the weights, the saved outputs and gy read, every gradient
    # written; operations: per layer the gates' recompute, dr W_hh^T and
    # dW_hh, and above layer 0 the input parts' recompute, dW_ih and dy.
    n_w = 2 * L - 1
    n_bytes = 4 * (2 * B * T_ * GH + (L + 1) * B * T_ * Hd + 2 * n_w * (Hd + 1) * GH)
    n_ops = 2 * B * T_ * Hd * GH * (3 * L + 3 * (L - 1))
    bound, by = _bound_ms(n_bytes, n_ops)
    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        Hd, Hd, num_layers=L, batch_first=True).cuda()
    x = torch.randn(B, T_, Hd, generator=gen).cuda().requires_grad_(True)
    with torch.no_grad():
        for l in range(L):
            getattr(lib, f"weight_hh_l{l}").copy_(w_hh[l].t())
            getattr(lib, f"bias_hh_l{l}").copy_(b_hh[l])
            if l:
                getattr(lib, f"weight_ih_l{l}").copy_(w_ih[l - 1].t())
                getattr(lib, f"bias_ih_l{l}").copy_(b_ih[l - 1])
    out = lib(x)[0]
    inputs = [x, *lib.parameters()]
    lib_fn = lambda: torch.autograd.grad(out, inputs, gy, retain_graph=True)  # noqa: E731
    library_device_ms, via = _library_device_ms(torch, lib_fn)
    device_ms = _graph_ms(torch, fn, 20)
    err = max((a - b).abs().max().item() for a, b in zip(fn(), plain()))
    return {"shape": [B, T_, Hd, L], "design": ops.bwd_design(T_, Hd, n_gates),
            "max_abs_err": err,
            "ms": _events_ms(torch, fn, 20),
            "device_ms": device_ms, "us_per_step": device_ms / (T_ * L) * 1e3,
            "plain_ms": _events_ms(torch, plain, 3, warmup=1), "bound_ms": bound, "bound_by": by,
            "library_ms": _events_ms(torch, lib_fn, 20), "library_device_ms": library_device_ms,
            "library_device_via": via, "device_busy_ms": _busy_ms(torch, fn, 20),
            "library_busy_ms": _busy_ms(torch, lib_fn, 20)}


def _bwd_rows(torch, gen, launches, errs, vm_launches) -> list[dict]:
    """The kernels line's backward rows at the training path's shapes: K3's
    at the deployed Mamba step and at VideoMamba's train step (its launches
    from the zoo phase's train run), K2's and K5's at the bench stack."""
    shapes = {"selective_scan_bwd": (TRAIN_BATCH, T, 16, 32)}
    shapes.update({n: (TRAIN_BATCH, T_UCF50, 56, 4) for n in BWD_KERNELS if n != "selective_scan_bwd"})
    rows = []
    for name, (source, replaces) in BWD_KERNELS.items():
        t = _bwd_timing(torch, gen, name, shapes[name])
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name][1],
                     "max_err_over_max_grad": errs[name][0], **t})
        if name == "selective_scan_bwd":
            rows.append({**rows[-1], "config": "videomamba",
                         "launches": vm_launches["selective_scan_bwd"],
                         **_bwd_timing(torch, gen, name, VIDEOMAMBA_STEP)})
    return rows


def _library_device_ms(torch, fn):
    """cuDNN's device time: its calls replayed from a CUDA graph, as for the
    kernels, or, where capture fails on the card (cuDNN's LSTM backward at
    T = 130), the time its kernels keep the card busy under
    ``torch.profiler``: the
    union of their intervals over 20 calls, per call (cuDNN's kernels may
    overlap, so their summed times would count a shared interval twice).
    Returns (ms, how)."""
    try:
        return _graph_ms(torch, fn, 20), "cuda_graph"
    except RuntimeError:
        torch.cuda.synchronize()
        return _busy_ms(torch, fn, 20), "profiler_kernel_union"


# Profiler sessions a measurement may take: on the H100 a session after the
# K2 timing rows' failed cuDNN graph captures has recorded no device
# activity at all (in two full runs of three), and a new session records it
# again.
PROFILER_TRIES = 3


def _kernels_a_call(torch, fn, calls: int = 20) -> float:
    """Device launches (kernels, copies, sets) ``torch.profiler`` records a
    call of ``fn``: ``calls`` calls in its active window, after a warm-up
    window of as many (a window without one missed the first launches).
    A session that records no device activity is run again, up to
    PROFILER_TRIES sessions; raises if none records any."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILER_TRIES):
        counts = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: counts.append(
                         sum(e.device_type == cuda for e in p.events()))) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        if counts and counts[0]:
            return counts[0] / calls
    raise RuntimeError(f"torch.profiler recorded no device activity in {PROFILER_TRIES} sessions")


def _busy_ms(torch, fn, calls: int) -> float:
    """Device time a call of ``fn``: the union of the intervals of every
    CUDA kernel, copy and set ``torch.profiler`` records over ``calls``
    calls, over ``calls``. A session that records no device activity is
    run again, up to PROFILER_TRIES sessions; raises if none records any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device activity in {PROFILER_TRIES} "
                           "sessions")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / calls


def _rnn_timing(torch, gen, ops, cell, kind, B, T_, Hd, L, in_size=512):
    """Time one K2/K5 entry point against its plain version and cuDNN's
    ``nn.LSTM`` / ``nn.GRU`` forward on the same function: layer 0's input
    projection from x (B, T, in_size) included in the library call only."""
    n_gates = 4 if cell == "lstm" else 3
    GH, k = n_gates * Hd, Hd ** -0.5
    L = L if kind == "stack" else 1
    _, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, max(L, 2))
    w_hh, b_hh, w_ih, b_ih = w_hh[:L], b_hh[:L], w_ih[:L - 1], b_ih[:L - 1]
    x = torch.randn(B, T_, in_size, generator=gen).cuda()
    w_ih0 = ((torch.rand(in_size, GH, generator=gen) * 2 - 1) * k).cuda()
    b_ih0 = ((torch.rand(GH, generator=gen) * 2 - 1) * k).cuda()
    xp = x @ w_ih0 + b_ih0
    if kind == "stack":
        op = getattr(ops, f"{cell}_stack")
        args = (xp, w_hh, b_hh, w_ih, b_ih)
        plain = ops.stack_ref
    else:
        op = getattr(ops, f"{cell}_scan")
        args = (xp, w_hh[0], b_hh[0])
        plain = getattr(ops, f"{cell}_scan_ref")
    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        in_size, Hd, num_layers=L, batch_first=True).cuda()
    with torch.no_grad():
        for l in range(L):
            getattr(lib, f"weight_ih_l{l}").copy_((w_ih0 if l == 0 else w_ih[l - 1]).t())
            getattr(lib, f"bias_ih_l{l}").copy_(b_ih0 if l == 0 else b_ih[l - 1])
            getattr(lib, f"weight_hh_l{l}").copy_(w_hh[l].t())
            getattr(lib, f"bias_hh_l{l}").copy_(b_hh[l])
    n_w = (2 * L - 1) if kind == "stack" else 1  # H x GH matrices the kernel applies
    bound, by = _bound_ms(4 * (B * T_ * GH + B * T_ * Hd + n_w * (Hd + 1) * GH),
                          2 * B * T_ * n_w * Hd * GH)
    with torch.inference_mode():
        got = op(*args)
        lib_diff = (lib(x)[0] - got).abs().max().item()
        err = (got - plain(*args)).abs().max().item()
        device_ms = _graph_ms(torch, lambda: op(*args), 20)
        library_device_ms, via = _library_device_ms(torch, lambda: lib(x))
        return {
            "shape": [B, T_, Hd, L], "design": ops.design(T_, Hd, L, n_gates),
            "ms": _events_ms(torch, lambda: op(*args), 20),
            "device_ms": device_ms, "us_per_step": device_ms / (T_ * L) * 1e3,
            "plain_ms": _events_ms(torch, lambda: plain(*args), 3, warmup=1),
            "library_ms": _events_ms(torch, lambda: lib(x), 20),
            "library_device_ms": library_device_ms, "library_device_via": via,
            "library_max_abs_diff": lib_diff, "max_abs_err": err,
            "bound_ms": bound, "bound_by": by,
        }


# The kernels line's rows of phase 22 (UCF50 at H = 128, "clusters"): each
# entry point the phase ran, the forward at its served request (B=4,
# cuDNN's layer 0 from the model's 32-wide input), the backward at its
# train step (B=32), the launches from that phase.
H128_ROWS = [("lstm_stack", (4, T_UCF50, 128, 4)), ("gru_stack", (4, T_UCF50, 128, 4)),
             ("gru_scan", (4, T_UCF50, 128, 1)),
             ("lstm_stack_bwd", (TRAIN_BATCH, T_UCF50, 128, 4)),
             ("gru_stack_bwd", (TRAIN_BATCH, T_UCF50, 128, 4)),
             ("gru_scan_bwd", (TRAIN_BATCH, T_UCF50, 128, 1))]


def _kernel_timings(torch, gen, launches, errs, gpu, vm_launches, h128_launches):
    from vct_torch.ops import lstm as rnn_ops
    from vct_torch.ops.preprocess import normalize_frames, normalize_frames_ref
    from vct_torch.ops.selective_scan import _launch as _scan_launch
    from vct_torch.ops.selective_scan import decode_plan
    from vct_torch.ops.selective_scan import plan as scan_plan
    from vct_torch.ops.selective_scan import plan_code as scan_plan_code
    from vct_torch.ops.selective_scan import selective_scan, selective_scan_ref

    def k3(B, L, D, N):
        args = _scan_inputs(torch, gen, B, L, D, N)
        bound, by = _bound_ms(4 * (3 * B * L * D + 2 * B * L * N + D * N), 7 * B * L * D * N)
        device_ms = _graph_ms(torch, lambda: selective_scan(*args), 20)
        code = scan_plan_code(B, D, N)
        return {
            "shape": [B, L, D, N], "plan": scan_plan(B, D, N),
            "ms": _events_ms(torch, lambda: selective_scan(*args), 20),
            # the wrapper's part of ms: the same launch without its checks and count
            "launch_ms": _events_ms(torch, lambda: _scan_launch(*args, False, code), 20),
            "device_ms": device_ms, "us_per_step": device_ms / L * 1e3,
            "plain_ms": _events_ms(torch, lambda: selective_scan_ref(*args), 3),
            "bound_ms": bound, "bound_by": by,
            # one expf a state and step, on the SFUs' MUFU.EX2 (16 a clock per SM)
            "expf_bound_ms": B * L * D * N / SFU_EXP_PER_S * 1e3,
        }

    def k3_plans(B, L, D, N):
        """Device time of the kernel under each S, with the plan's blocks and
        chunks and with 64- and 256-thread blocks and 32-step chunks, against
        the plan's choice; each checked against the plain version first."""
        args = _scan_inputs(torch, gen, B, L, D, N)
        want = selective_scan_ref(*args)
        times = {}
        for S in (1, 2):
            for threads, chunk in ((0, 0), (64, 0), (256, 0), (0, 32)):
                code = scan_plan_code(B, D, N, S, threads, chunk)
                p = decode_plan(code, N)
                got = _scan_launch(*args, False, code)
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                key = (f"S{S}_lanes{p['lanes_per_channel']}_T{p['block_threads']}"
                       f"_C{p['chunk_steps']}")
                times[key] = _graph_ms(torch, lambda: _scan_launch(*args, False, code), 20)
        return {"shape": [B, L, D, N], "plan": scan_plan(B, D, N), "device_ms": times}

    def k6(shape):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
        mean, std = torch.tensor(IMAGENET_MEAN).cuda(), torch.tensor(IMAGENET_STD).cuda()
        n = x.numel()
        # 1 byte read and 4 written per element, the (C,) mean and std read;
        # 4 operations per element: widen, scale, subtract, multiply.
        bound, by = _bound_ms(5 * n + 2 * 4 * 3, 4 * n)
        return {
            "shape": list(shape), "stats": "imagenet",
            "ms": _events_ms(torch, lambda: normalize_frames(x, mean, std), 20),
            "device_ms": _graph_ms(torch, lambda: normalize_frames(x, mean, std), 20),
            "plain_ms": _events_ms(torch, lambda: normalize_frames_ref(x, mean, std), 5),
            "bound_ms": bound, "bound_by": by,
        }

    t1, t3 = _k1_timing(torch, gen, 32, 2 * T), k3(32, T, 16, 32)
    t4, t6 = _k4_timing(torch, gen, 32, 2 * T), k6((32, T, H, W, 3))
    kernels = [
        {"name": "pair_scores", "route": "cuda", "source": "vct_torch/csrc/pair_scores.cu",
         "replaces": "vct/ops/pair_scores_pallas.py:119", "launches": launches["pair_scores"],
         "max_abs_err": errs["pair_scores"], "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": None,
         "device_ms": t1["device_ms"], "shape": t1["shape"], "plan": t1["plan"],
         "launch_ms": t1["launch_ms"]},
        {"name": "selective_scan", "route": "cuda", "source": "vct_torch/csrc/selective_scan.cu",
         "replaces": "vct/ops/selective_scan_pallas.py:111",
         "launches": launches["selective_scan"], "max_abs_err": errs["selective_scan"],
         "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": None,
         "device_ms": t3["device_ms"], "shape": t3["shape"], "plan": t3["plan"],
         "us_per_step": t3["us_per_step"], "expf_bound_ms": t3["expf_bound_ms"],
         "launch_ms": t3["launch_ms"]},
        {"name": "ssim_pair_scores", "route": "cuda", "source": "vct_torch/csrc/ssim.cu",
         "replaces": "vct/ops/ssim_pallas.py:156", "launches": launches["ssim_pair_scores"],
         "max_abs_err": errs["ssim_pair_scores"], "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"], "library_ms": None,
         "bound_counts": t4["bound_counts"], "device_ms": t4["device_ms"], "shape": t4["shape"],
         "plan": t4["plan"]},
        {"name": "normalize_frames", "route": "cuda", "source": "vct_torch/csrc/normalize.cu",
         "replaces": "vct/ops/preprocess_pallas.py:34", "launches": launches["normalize_frames"],
         "paths": "none: no serving path calls it, as in vct",
         "max_abs_err": errs["normalize_frames"], "ms": t6["ms"], "plain_ms": t6["plain_ms"],
         "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"], "library_ms": None,
         "device_ms": t6["device_ms"], "shape": t6["shape"]},
    ]
    t3vm = k3(*VIDEOMAMBA_STEP)
    kernels.append({**kernels[1], "config": "videomamba",
                    "launches": vm_launches["selective_scan"],
                    **{k: t3vm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                            "shape", "plan", "us_per_step", "expf_bound_ms",
                                            "launch_ms")}})
    for name in RNN_KERNELS:
        cell, kind = name.split("_")
        t = _rnn_timing(torch, gen, rnn_ops, cell, kind, 32, T_UCF50, 56, 4)
        kernels.append({
            "name": name, "route": "cuda", "source": "vct_torch/csrc/lstm.cu",
            "replaces": RNN_KERNELS[name], "launches": launches[name], "max_abs_err": errs[name],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "device_ms", "us_per_step", "design", "library_device_ms",
                                       "library_device_via", "library_max_abs_diff", "shape")},
        })
    for name, (B, T_, Hd, L) in H128_ROWS:
        cell, kind = name.split("_")[:2]
        if name in BWD_KERNELS:
            source, replaces = BWD_KERNELS[name]
            t = _bwd_timing(torch, gen, name, (B, T_, Hd, L))
        else:
            source, replaces = "vct_torch/csrc/lstm.cu", RNN_KERNELS[name]
            t = _rnn_timing(torch, gen, rnn_ops, cell, kind, B, T_, Hd, L,
                            in_size=UCF50_H128["rnn_input_size"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "config": "ucf50_h128", "launches": h128_launches[name],
            "plan": rnn_ops.plan(B, T_, Hd, L, 4 if cell == "lstm" else 3,
                                 backward=name in BWD_KERNELS),
            **{key: t[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "device_ms", "us_per_step", "design",
                                       "library_device_ms", "library_device_via", "shape")}})
    extra = {"extra_timings": {
        "pair_scores_B32_L120_flow": _k1_timing(torch, gen, 32, 2 * T, method="flow"),
        "pair_scores_B1_L120_sad": _k1_timing(torch, gen, 1, 2 * T),
        "pair_scores_B1_L240_sad": _k1_timing(torch, gen, 1, 4 * T),
        "pair_scores_B1_L120_320x240_sad": _k1_timing(torch, gen, 1, 2 * T, 240, 320),
        "pair_scores_plans": [_k1_plans(torch, gen, *shape) for shape in K1_SHAPES],
        "ssim_pair_scores_B1_L120": _k4_timing(torch, gen, 1, 2 * T),
        "ssim_pair_scores_B1_L240": _k4_timing(torch, gen, 1, 4 * T),
        "ssim_pair_scores_B1_L120_320x240": _k4_timing(torch, gen, 1, 2 * T, 240, 320),
        "ssim_pair_scores_plans": [_k4_plans(torch, gen, *shape) for shape in SSIM_PLAN_SHAPES],
        "selective_scan_B4_served": k3(4, T, 16, 32),
        "selective_scan_D2048_N16": k3(2, 256, 2048, 16),
        "selective_scan_N64": k3(32, T, 32, 64),
        "selective_scan_plans": [k3_plans(*dims) for dims in SCAN_PLAN_SHAPES],
        "lstm_stack_B4_served": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 4, T_UCF50, 56, 4),
        "gru_stack_B4_served": _rnn_timing(torch, gen, rnn_ops, "gru", "stack", 4, T_UCF50, 56, 4),
        "lstm_stack_H64_L4": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T_UCF50, 64, 4),
        "gru_stack_H64_L4": _rnn_timing(torch, gen, rnn_ops, "gru", "stack", 32, T_UCF50, 64, 4),
        "lstm_stack_default_H32_T60_L3": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T,
                                                     32, 3),
        "lstm_stack_H65_L4": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 32, T_UCF50, 65, 4),
        "lstm_stack_H256_L2": _rnn_timing(torch, gen, rnn_ops, "lstm", "stack", 2, 16, 256, 2,
                                          in_size=256),
        "lstm_stack_bwd_T130": _bwd_timing(torch, gen, "lstm_stack_bwd",
                                           (TRAIN_BATCH, BWD_LONG_T, 56, 4)),
        **{f"lstm_stack_bwd_H{dims[2]}_L{dims[3]}": _bwd_timing(torch, gen, "lstm_stack_bwd",
                                                                 dims)
           for dims in BWD_WIDE_SHAPES},
        "selective_scan_bwd_videomamba": _bwd_timing(torch, gen, "selective_scan_bwd",
                                                     VIDEOMAMBA_SCAN),
    }, "gpu": gpu}
    print(json.dumps(extra))
    return kernels


def k1_timings(torch, root: Path) -> dict:
    """``_k1_timing`` at K1's five timed shapes (the bench step, SAD and flow,
    the two served buckets, one decoded 320x240 video) for the
    ``vct_torch`` package at ``root``: this checkout's, or an older one's."""
    sys.path.insert(0, str(root))
    gen = torch.Generator().manual_seed(0)
    return {"k1_timings": [_k1_timing(torch, gen, 32, 2 * T, method=m) for m in ("sad", "flow")]
            + [_k1_timing(torch, gen, *shape[:4]) for shape in K1_SHAPES[1:]],
            "root": str(root), "gpu": _gpu_line()}


def bwd_timings(torch, root: Path) -> dict:
    """The backward entry points at the training path's shapes, by events
    and from a CUDA graph, for the ``vct_torch`` package at ``root``: this
    checkout's or an older one's. K3's at the deployed step and at
    VideoMamba's shape, with the device launches a call (``torch.profiler``);
    K2/K5's at the bench stack (K5 its first layer), the LSTM stack's at
    T = BWD_LONG_T (three staged chunks), and the LSTM stack's above H = 64
    (BWD_WIDE_SHAPES, the "clusters" design) as ``_bwd_timing`` gives it,
    with cuDNN's backward beside it. Uses only the entry points, K2's
    forward ``_launch``, ``bwd_design`` and ``stack_bwd_ref``."""
    sys.path.insert(0, str(root))
    from vct_torch.ops import lstm as ops
    from vct_torch.ops import selective_scan as k3

    gen = torch.Generator().manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for label, dims in (("selective_scan_bwd", (TRAIN_BATCH, T, 16, 32)),
                        ("selective_scan_bwd_videomamba", VIDEOMAMBA_SCAN)):
        args = _scan_inputs(torch, gen, *dims)
        gy = torch.randn(dims[:3], generator=gen).cuda()
        fn = lambda: k3.selective_scan_bwd(*args, gy)  # noqa: E731
        rows[label] = {"shape": list(dims), "ms": _events_ms(torch, fn, 20),
                       "device_ms": _graph_ms(torch, fn, 20),
                       "kernel_launches": _kernels_a_call(torch, fn)}
    cases = [(n, T_UCF50) for n in BWD_KERNELS if n != "selective_scan_bwd"]
    for name, T_ in cases + [("lstm_stack_bwd", BWD_LONG_T)]:
        cell, kind, _ = name.split("_")
        n_gates = 4 if cell == "lstm" else 3
        xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, TRAIN_BATCH, T_, 56, 4)
        gy = torch.randn(TRAIN_BATCH, T_, 56, generator=gen).cuda()
        if kind == "stack":
            y, hs, _ = ops._launch(f"{cell}_stack", n_gates, xp, w_hh, b_hh, w_ih, b_ih, save=True)
            fn = lambda: getattr(ops, name)(xp, w_hh, b_hh, w_ih, b_ih, hs, y, gy)  # noqa: E731
        else:
            args = (xp, w_hh[0], b_hh[0])
            y, _, _ = ops._launch(f"{cell}_scan", n_gates, *args)
            fn = lambda: getattr(ops, name)(*args, y, gy)  # noqa: E731
        rows[name if T_ == T_UCF50 else f"{name}_T{T_}"] = {
            "ms": _events_ms(torch, fn, 20), "device_ms": _graph_ms(torch, fn, 20)}
    for dims in BWD_WIDE_SHAPES:  # with cuDNN's backward beside it
        rows[f"lstm_stack_bwd_H{dims[2]}_L{dims[3]}"] = _bwd_timing(torch, gen, "lstm_stack_bwd",
                                                                     dims)
    return {"bwd_timings": rows, "root": str(root), "gpu": _gpu_line()}


# K2/K5 rows of ``--rnn-timing`` (B, T, H, L, the input width of cuDNN's
# layer 0): the kernel table's rows above H = 64 (H=256 at B=2, H=65 at
# B=32), the H = 128 phase's width and H = 256 at B = 32.
RNN_TIMING_ROWS = [(2, 16, 256, 2, 256), (32, T_UCF50, 65, 4, 512), (32, T_UCF50, 128, 4, 512),
                   (32, T_UCF50, 256, 2, 256)]


def _cluster_plans(torch, gen, ops, cell, B, T_, Hd, L) -> dict:
    """The "clusters" forward (the stack, K5 at L = 1) and one backward
    layer at (B, T, H) under every plan the kernels take: each checked
    against its plain version first, then its device ms from a CUDA graph,
    beside how many of its clusters the card holds at once."""
    n_gates = 4 if cell == "lstm" else 3
    xp, w_hh, b_hh, w_ih, b_ih = _rnn_inputs(torch, gen, n_gates, B, T_, Hd, max(L, 2))
    args = (xp, w_hh[:L], b_hh[:L], w_ih[:L - 1], b_ih[:L - 1])
    name = f"{cell}_stack" if L > 1 else f"{cell}_scan"
    if L > 1:
        want = ops.stack_ref(*args)
    else:
        args = (xp, w_hh[0], b_hh[0])
        want = getattr(ops, f"{cell}_scan_ref")(*args)
    GH = n_gates * Hd
    x = torch.randn(B, T_, GH, generator=gen).cuda()
    h = torch.randn(B, T_, Hd, generator=gen).tanh().cuda()
    bx, bh = (torch.randn(2, GH, generator=gen) * 0.1).cuda()
    dy = torch.randn(B, T_, Hd, generator=gen).cuda()
    layer = (n_gates, x, h @ w_hh[0], bx, bh, h, w_hh[0], dy)
    ref = [torch.empty_like(x), torch.empty_like(x), x.new_empty(2, B, GH)]
    ops.layer_bwd_ref(*layer, *ref)
    out = [torch.empty_like(t) for t in ref]
    times = {}
    for n in (8, 16):
        if -(-Hd // n) > 16:
            continue
        for R in (1, 2, 4):
            fwd = lambda: ops._launch(name, n_gates, *args, cluster=(n, R))  # noqa: E731
            bwd = lambda: ops._layer_bwd(*layer, *out, cluster=(n, R))  # noqa: E731
            torch.testing.assert_close(fwd()[0], want, atol=1e-5, rtol=1e-5)
            bwd()
            _grads_close(torch, f"{name} backward plan ({n}, {R})", out, ref, ("x", "R", "b"))
            times[f"n{n}_R{R}"] = {
                "fwd_device_ms": _graph_ms(torch, fwd, 20),
                "bwd_layer_device_ms": _graph_ms(torch, bwd, 20),
                "resident": ops.plan(B, T_, Hd, L, n_gates, cluster=n, rows=R)["resident"],
                "resident_bwd": ops.plan(B, T_, Hd, L, n_gates, True, n, R)["resident"]}
    return {"shape": [B, T_, Hd, L], "cell": cell, "plan": ops.plan(B, T_, Hd, L, n_gates),
            "device_ms": times}


def rnn_timings(torch, root: Path) -> dict:
    """K2/K5 above H = 64 for the ``vct_torch`` package at ``root`` (this
    checkout's or an older one's): at each of RNN_TIMING_ROWS, LSTM and GRU,
    the stack's forward (``_rnn_timing``: device ms from a CUDA graph beside
    cuDNN's ``nn.LSTM`` / ``nn.GRU``) and its backward entry point
    (``_bwd_timing``, cuDNN's backward beside it), and K5 forward and
    backward at B=32 T=40 H=128; where the package has the "clusters"
    design, each row's plan and every plan's device time
    (``_cluster_plans``). Uses only the entry points, ``design``,
    ``bwd_design``, K2's forward ``_launch`` and the plain versions."""
    sys.path.insert(0, str(root))
    from vct_torch.ops import lstm as ops

    gen = torch.Generator().manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    cases = [(cell, "stack", *dims) for dims in RNN_TIMING_ROWS for cell in ("lstm", "gru")]
    cases += [(cell, "scan", 32, T_UCF50, 128, 1, 512) for cell in ("lstm", "gru")]
    for cell, kind, B, T_, Hd, L, in_size in cases:
        label = f"{cell}_{kind}_B{B}_T{T_}_H{Hd}_L{L}"
        row = {"fwd": _rnn_timing(torch, gen, ops, cell, kind, B, T_, Hd, L, in_size=in_size),
               "bwd": _bwd_timing(torch, gen, f"{cell}_{kind}_bwd", (B, T_, Hd, L))}
        if hasattr(ops, "plan"):
            row["plan"] = ops.plan(B, T_, Hd, L, 4 if cell == "lstm" else 3)
            row["plans"] = _cluster_plans(torch, gen, ops, cell, B, T_, Hd, L)
        rows[label] = row
        print(json.dumps({label: row}), flush=True)
    return {"rnn_timings": rows, "root": str(root), "gpu": _gpu_line()}


def step_timings(torch, root: Path) -> dict:
    """The end-to-end steps of the existing configurations for the
    ``vct_torch`` package at ``root`` (this checkout's or an older one's):
    the bench-shaped serving steps of ``_bench_and_hold`` (deployed Mamba
    with SAD and SSIM selection, UCF50 LSTM; B=32, raw L=2T, ragged, the
    same seeded inputs) and the train steps of ``_train_hold_and_time`` (B=32
    f32 clips on the card), each three times by events, sorted. Uses only
    ``build_model``, ``device_sample_clips`` and ``Trainer``."""
    sys.path.insert(0, str(root))
    import vct_torch.data.preprocess as preprocess
    from vct_torch.core.config import Config, ModelConfig
    from vct_torch.models import build_model
    from vct_torch.ops import _build
    from vct_torch.train.engine import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_kernels()
    out = {}
    ucf50 = {**UCF50, "rnn_type": "lstm"}
    for label, model, seq_len, method in (("deployed_mamba", DEPLOYED, T, "sad"),
                                          ("deployed_mamba_ssim", DEPLOYED, T, "ssim"),
                                          ("ucf50_lstm", ucf50, T_UCF50, "sad")):
        net = build_model(ModelConfig(**model, compute_dtype="bfloat16"), seq_len, seed=0)
        rng = np.random.RandomState(1)
        raw = torch.from_numpy(rng.randint(0, 256, (32, 2 * seq_len, H, W, 3),
                                           dtype=np.uint8)).cuda()
        lens = torch.from_numpy(rng.randint(seq_len + 1, 2 * seq_len + 1, size=32)).cuda()
        with torch.inference_mode():
            step = lambda: net(preprocess.device_sample_clips(  # noqa: E731
                raw, seq_len, method=method, lengths=lens))
            out[f"{label}_serve_ms"] = sorted(_events_ms(torch, step, 20) for _ in range(3))
        del net
    for label, (model, seq_len) in TRAIN_CONFIGS.items():
        cfg = Config().replace(**{"data.sequence_length": str(seq_len),
                                  "train.batch_size": str(TRAIN_BATCH),
                                  "model.compute_dtype": "bfloat16", "model.dropout": "0.0",
                                  **{f"model.{k}": str(v) for k, v in model.items()}})
        trainer = Trainer(cfg, [f"class_{i}" for i in range(cfg.model.num_classes)])
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(0)
        clips = torch.rand(TRAIN_BATCH, seq_len, H, W, 3, generator=gen).cuda()
        labels = torch.randint(0, cfg.model.num_classes, (TRAIN_BATCH,), generator=gen).cuda()
        mask = torch.ones(TRAIN_BATCH, device=clips.device)
        step = lambda: trainer._train_step(state, clips, labels, mask)  # noqa: E731
        out[f"{label}_train_ms"] = sorted(_events_ms(torch, step, 10, warmup=2)
                                          for _ in range(3))
        del trainer, state
    torch.cuda.empty_cache()
    return {"step_timings": out, "root": str(root), "gpu": _gpu_line()}


def main(argv: list[str]) -> int:
    """With no arguments, every phase; with ``--k1-timing [ROOT]``,
    ``--bwd-timing [ROOT]`` or ``--step-timing [ROOT]``, only
    ``k1_timings``, ``bwd_timings`` or ``step_timings`` of the package at
    ROOT (default: this checkout)."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if argv[:1] == ["--mesh-rank"]:  # a rank of phase 20's two-rank world
        sys.path.insert(0, str(here))
        _mesh_rank(torch, Path(argv[1]))
        return 0
    modes = {"--k1-timing": k1_timings, "--bwd-timing": bwd_timings,
             "--step-timing": step_timings, "--rnn-timing": rnn_timings}
    if argv[:1] and argv[0] in modes:
        print(json.dumps(modes[argv[0]](torch, Path(argv[1]).resolve() if argv[1:] else here)))
        return 0
    sys.path.insert(0, str(here))
    from vct_torch.ops import _build

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s into {_build.build_dir()}", flush=True)
    log = (_build.build_dir() / "build.log").read_text()
    print("\n".join(_ptxas_lines(log)))
    spills = _bwd_spills(log)
    spilled = {k: v for k, v in spills.items() if v}
    print(f"K2/K5 backward: {len(spills)} register-design instances, spill bytes {spilled or 0}")
    if spilled:
        raise AssertionError(f"backward register instances spill: {spilled}")

    gen = torch.Generator().manual_seed(0)
    errs = {"pair_scores": _check_pair_scores(torch, gen),
            "ssim_pair_scores": _check_ssim(torch, gen),
            "normalize_frames": _check_normalize(torch, gen),
            "selective_scan": _check_selective_scan(torch, gen),
            **_check_rnn(torch, gen)}
    bwd_errs = _check_backward(torch, gen)

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(ModelConfig(**DEPLOYED, compute_dtype="bfloat16"), T, seed=0)
    # K1, K3: the SAD Mamba path's counts; K4: the SSIM Mamba path's.
    launches = _serve_deployed(torch, gpu, model, ("sad",) * 3, "deployed_mamba")
    ssim_launches = _serve_deployed(torch, gpu, model, ("ssim", "ssim_most_unique", "ssim"),
                                    "deployed_mamba_ssim")
    del model
    rnn_launches = _recurrent_path(torch, gpu)
    print(f"LSTM/GRU path launches over the four heads {rnn_launches}")
    launches.update({n: rnn_launches[n] for n in RNN_KERNELS})
    launches["ssim_pair_scores"] = ssim_launches["ssim_pair_scores"]
    launches["normalize_frames"] = sum(
        c["normalize_frames"] for c in (launches, ssim_launches, rnn_launches))
    train_launches = _train_path(torch, gen, gpu)
    print(f"training path launches over both configurations {train_launches}")
    _resume_and_weights(torch, gpu)
    zoo = _zoo_path(torch, gen, gpu)
    _caption_path(torch, gen, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        decodes = _files_path(torch, gpu, Path(tmp))
        _worker_path(torch, gpu, Path(tmp), decodes)
        _caption_files_path(torch, gpu, Path(tmp) / "captions")
        _aot_path(torch, gpu, Path(tmp))
        _sweep_path(torch, gpu, Path(tmp) / "sweep", here)
        _mesh_path(torch, gpu, Path(tmp), here)
    _finetune_path(torch, gpu)
    h128_launches = _h128_path(torch, gen, gpu)
    kernels = _kernel_timings(torch, gen, launches, errs, gpu, zoo["served"], h128_launches)
    kernels += _bwd_rows(torch, gen, train_launches, bwd_errs, zoo["trained"])
    print(json.dumps({"kernels": kernels, "gpu": gpu}))
    print(_gpu_line())  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
