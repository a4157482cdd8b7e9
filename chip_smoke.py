#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — compile every kernel under ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. kernels vs plain — each kernel against its plain torch version on the
   card, timed with CUDA events and the profiler beside its device-memory
   bound: ``dasha_update`` (the dense-mask entry) at the flat path's (5,
   20958), the ResNet-18 width (5, 11173962) and a ragged misaligned (3,
   4099); ``dasha_mvr_update`` at (4, 20958), the Mamba2-780M tied
   embedding leaf (4, 77463552), starcoder2-3b's embedding leaf (4,
   150994944) and the ragged misaligned shape, on an fp32
   mask, the trainer's bool draw and one shared bool row; then kernel 2
   (``QUANT_CASES``, ``FUSED_CASES``): the device floor of one launch (a
   one-element torch add), ``quantize`` by the one-level rule and two
   launches bit-identical on the cluster path at (5 | 20 | 64, 20958),
   float4 at (5, 4096), scalar at the misaligned (3, 4099), two passes at
   (5, 11173962), 65,600 rows of 256 by both paths, 8 vectors a thread
   (float4 at (5, 100000), scalar at (3, 30001)), and the cluster-of-8
   plans of a card that schedules no 16 (forced through the private
   entry) at (5 | 20, 20958), (5, 4096) and (3, 4099); the fused QDither
   entry ``dasha_quantize_update`` at (5 | 20, 20958), 8 lanes x 5 rows
   on (5, d) uniforms, an (n, 1) scale with a zero row, 4 lanes x 3
   rows of 150,000, too wide for a cluster, with coins, (5, 100000) with
   coins and (5, 20958) by the cluster-of-8 plan (h_out is h_new; delta
   exact: the plain entry on the torch chain's delta by the same plan
   gives m bit for bit; m by the one-level rule times the scale; g_new ==
   g_local + m bit for bit); each entry must have run its cluster kernels
   of 8 vectors a thread (``QUANT_MUST_RUN``); and at (5 | 20, 20958), in
   turns (old, new, new, old), the cluster path against the two-pass path
   forced through the private entry, which must be at least
   ``CLUSTER_SPEEDUP_MIN`` times slower (a planted fault, the two-pass
   path timed as the new arm, must fail that gate), and the fused entry
   against the unfused chain (torch delta, two-pass quantize, * scale,
   + g_local) as one device-time sum; then kernel 1's sparsifier entry
   ``dasha_sparsify_update`` (``SPARSIFY_CASES``: RandK at (5 | 20 | 64,
   20958), with coins, at the cohort's scale, 8 lanes x 5 rows on the
   plan's 5 index rows, shared_coords on one row, PermK with PAD,
   passthrough with coins, a Bernoulli mask on misaligned (3, 4099), the
   tree path's shared bool row, the ResNet-18 width) bit-equal to its
   plain version (the chain: mask built, scale folded in, the dense-mask
   update) with h_out the caller's grad; and at (5 | 20, 20958), in turns, the chain it replaced (the plan's
   indices to a dense mask, the coins folded in, the dense-mask entry) as
   one device-time sum, which must be at least ``SPARSIFY_SPEEDUP_MIN``
   times the entry's (a planted fault, the chain timed as the new arm,
   must fail that gate);
3. flat main path — DASHA's flat Algorithm-1 round at the LIBSVM real-sim
   shape (n = 5 nodes x m = 14,461 samples, d = 20,958; synthetic data made
   on the card from a seed) through Method.build / init / Driver.run: dasha
   with fused RandK, dasha with fused QDither (its profiled window must
   hold one fused kernel-2 launch a round, no two-pass kernel and no
   kernel of the plain entry; device launches and ms a round reported),
   page with fused RandK (the RandK windows must hold one launch of
   kernel 1's sparsifier entry a round, no mask scatter and no dense-mask
   kernel);
4. flat agreement — all 5 variants x dense/sparse/fused on the quickstart
   problem, on the card and on the CPU with the same injected draws;
5. trainer main path — ``repro_torch.launch.train.train`` on Mamba2-780M
   at full width (d_model 1536, vocab 50,432) with the depth cut to
   ``TRAIN_LAYERS`` of 48 layers (n = 4 nodes of fp32 state, the round's
   new trees and one node's activations: 32 layers ran out of the card's
   80 GB), n = 4, batch 2 per node,
   seq 512, DASHA-MVR with the fused kernel and an Adam server; rounds/s,
   tokens/s, peak memory, eval loss before and after, kernel launches
   (= leaves x rounds; kernel 3 reads each leaf's bool draw) and a
   profiled window with its device launches a round;
6. trainer agreement — a smoke-size float32 Mamba2 trained on the card and
   on the CPU with the same injected masks, coins and batches, for dasha /
   mvr / sync_mvr x independent / permk x use_kernel off / on;
7. ssd_chunk vs plain — the SSD intra-chunk kernel against its plain torch
   version in bf16 and fp32 at one layer of the serving prefill (x (4,
   32768, 48, 64) as a view of the conv output, b/c (4, 32768, 128), Q =
   256), at the smoke model's (2, 64, 8, 32, 16), Q = 32, and at ragged
   (1, 128, 4, 16, 8), Q = 32 and (2, 32, 3, 4, 5), Q = 8; each output
   within 1e-4 of the plain version's largest magnitude, two launches
   bit-identical, timed beside two bounds: the float32 CUDA-core one of
   the work the inputs need, and that of the tensor-core arithmetic the
   kernel runs (passes counted); the built library's SASS must hold
   tensor-core instructions (HMMA/HGMMA, counted with cuobjdump);
8. serve main path — ``repro_torch.launch.serve`` on Mamba2-780M at full
   width and full depth (48 layers, bf16, random weights from a seed):
   (a) ``prefill_logits`` at batch 4 x 32,768 tokens, 1 warm-up + 2 timed
   calls and a profiled one (``ssd_chunk`` launches = 48 a call: the
   kernel's launches on the main path); (b) ``serve`` at batch 128, a
   32-token prompt stepped through ``decode_step`` and 32 new tokens
   (the recurrence, no kernel); (c) ``prefill_logits`` against the 512th
   decode step of ``serve`` on a 512-token prompt at batch 2 in float32;
9. serve agreement — the smoke Mamba2 in float32 prefilled (kernel on
   the card, plain version on the CPU) and served on the card and on the
   CPU with the same params and prompt: logits within 1e-4 of the largest
   magnitude, equal tokens;
10. slab_writeback vs plain — the slab-writeback kernel against its plain
    version, set and accumulate bit for bit, at the cross-device cell's
    chunk slab (U 8,192 rows with its realized sentinel tail into n =
    100,000 x d = 20,958), at (U 64, n 110,000, d 20,958) with ids at the
    end (n*d > 2^31), ragged (U 37 with 5 sentinels, n 1,000, d 4,099) on
    an offset view, all-sentinel and U = n, timed beside its bound and one
    ``index_copy_`` / ``index_add_`` call;
11. federated main path — ``repro_torch.fed.VecFedSim`` on
    ``SampledFlatSubstrate``: cross-device DASHA with n = 100,000 clients
    x m = 1 x d = 20,958 (synthetic data made on the card), C = 64, fused
    RandK K = 100, a lognormal-straggler uplink, 1,000 rounds in chunks of
    128 on the slab store after a warm-up chunk.  A timed run with no
    check inside it gives rounds/s and peak memory (the caller's state is
    kept on the host) and gates on the launches (16 slab writebacks, 1,000
    fused updates), participants and bytes; a second, gated run from the
    same state watches every writeback (untouched and written store rows)
    and must repeat the first bit for bit; the caller's state must be
    unchanged; then a profiled chunk, and kernel 1's sparsifier entry
    against its plain version at the cohort's (64, 20958) on a real
    round's RandK indices and the plan scale d/K * n/C;
12. federated agreement — the example's shape (n = 256, m = 8, d = 40,
    K = 8, C in 256/64/16) for dasha/page x randk sparse/fused and mvr on
    a stochastic problem, card vs CPU with the same injected draws (exact
    byte traces, metrics within 1e-4); slab vs scatter bit for bit on the
    card at n = 10,000, C = 64, d = 20,958, 128 rounds;
13. heap oracle — ``repro_torch.fed.FedSim``, every upload through the
    byte codec: (a) fed_bench's straggler_curves at the real-sim shape
    (data made on the card once): dasha, dasha with Appendix-D
    participation p' = 0.5 and marina (p = max(zeta/d, 8/200)), fused
    RandK K = 100, uplink 1e6 B/s with a lognormal straggler sigma in
    (0, 1, 2), 200 rounds each, and dasha with fused QDither s = 15 at
    sigma = 1; gates: every upload verified and decoded to its message
    rows, exact bytes, bytes equal across sigma, metric traces equal to a
    plain Driver run bit for bit, MARINA's wall clock degrading more than
    DASHA's, launches (1,800 of kernel 1, 200 of kernel 2); rounds/s, host
    ms a round in the engine, the codec and the heap, a profiled chunk;
    (b) the sampled heap campaign on the slab store, n = 10,000, C = 64,
    sparse RandK, 256 rounds (4 writebacks), equal to VecFedSim in bytes
    and participants; (c) n = 5, d = 2,048, dasha and marina, card vs CPU
    with injected CPU draws;
14. stepsize sweep at real-sim — ``repro_torch.methods.Sweeper`` on
    phase 3's data (made on the card): benchmarks/fig1_gradient.py's
    protocol, dasha and marina (batch 0, p = marina_p(K, d)) with fused
    RandK K = 100, 8 stepsizes gamma_dasha(L, L, omega, n) * 2^i as one
    sweep of 8 lanes each, 200 rounds with ||grad f||^2 every round
    through the lane oracles; gates: the lowest-gamma lane and the best
    finite lane each equal a sequential Driver run over 50 rounds
    (bits_sent exactly, ||grad f||^2 within 1e-4 relative, non-finite
    entries in the same places) and, from a sweep of the 8 gammas plus a
    fast ninth lane gamma_dasha * 2^16 over 50 rounds, the final iterate
    of each (and the fast lane's h_i) within 1e-2 of the sequential one
    relative to its move from x0, where planted faults (a lane frozen at
    x0, two lanes swapped, h_i left at x0) must fail; kernel 1 launched
    once a round for all 8 lanes and nothing else launched, peak memory
    <= 8 GB, the best lane ending below its x0 ||grad f||^2; reported:
    rounds/s and lane-rounds/s against the sequential runs, a profiled
    window's busy share and top kernels, each method's best gamma and
    coords to eps; then kernel 1's sparsifier entry against its plain
    version at the sweep's (40, 20958) rows on the plan's 5 index rows,
    and the
    port's fig1, fig5 and table1 at the reference's rounds, fig2 at a
    64th and fig3 at a 320th of theirs (``FIG_ROUNDS_SCALE``), their
    rows printed
    (gates: fig1's DASHA-over-MARINA speedup > 1, fig5's floor ordering);
15. faulted campaigns at the real-sim width — ``repro_torch.fed.faults``
    through the engine's ``faults=`` hook, with benchmarks/
    fed_faults_bench.py's configuration widened to real-sim's features: n =
    20 clients x m = 3,615 samples x d = 20,958 (data made on the card),
    fused RandK K = 100, uplink 1e6 B/s, downlink 1e8 B/s, 1 ms latency,
    no compute time, p_crash 0.02 for 2 rounds, deadline 3x, fault seed 7.
    (a) ``bench.fed_faults.degradation_sweep`` through VecFedSim: the drop
    grid {0, 0.05, 0.1, 0.2} x {dasha, marina}, 240 rounds each, with the
    bench's four gates (MARINA's metric and final x bit-identical across
    the grid, DASHA finite and within 10x of its fault-free metric, DASHA's
    wall-clock inflation <= 3, MARINA paying more time, bytes and > 0
    retries at 20% loss), every campaign dropping some round, kernel 1
    once a round, and a profiled chunk; (b) heap == vec, 40 rounds each:
    dasha under the tests' FM_MIXED (reset rejoins) and marina under
    FM_SYNC, every arriving upload verified and every corrupted one caught
    by the wire checksum; gates: integer traces equal, wall clock within
    2e-6 and metric within 1e-4 relative, ||g - mean g_i|| <= 1e-5 ||g||
    after the reset campaign, and a planted fault (drop_up one round
    late) failing the integer gate; (c) the same for dasha with fused
    QDither s = 15 (kernel 2); (e) the dasha FM_MIXED campaign once more,
    each engine step held against the faulted DASHA round written out by
    hand on the step's own input state and masks (x, g, g_local, h_local
    within 1e-3 of how far the round could move each row; a planted
    fault, a dropped client's round committed, must fail it); the absolute
    peak gated at 8 GB; kernels 1 (the sparsifier entry, the campaigns' a
    and d/K on a real round's RandK indices, bit-equal) and 2 (s = 15, the one-level rule) against their
    plain versions at the campaigns' (20, 20958) rows; (d) card vs CPU at
    n = 5, m = 32, d = 40: faulted dasha and marina through both
    simulators with the same injected draws (integer traces equal, metric,
    wall clock and final x within 1e-4);
16. asynchronous pipelined rounds (``tau=``) — benchmarks/
    fed_async_bench.py's configuration widened to real-sim's features as
    in phase 15 (n = 20 x m = 3,615 x d = 20,958, fused RandK K = 100, the
    bench's links: uplink 1e6 B/s with a lognormal straggler, downlink
    1e8 B/s, 1 ms latency, no compute time, network seed 7).  (a) its
    severity sweep through VecFedSim: tau = 2, sigma in {0, 1, 2}, dasha
    and marina (p = 0.15), barrier and async, 300 rounds each, and its
    tau sweep (0, 1, 2, 4 at sigma = 2, 150 rounds); gates: the bench's
    five booleans, the tau sweep monotone, kernel 1 once a round, tau = 0
    == the barrier on the card bit for bit (every trace, the final
    state); rounds/s async against barrier and a profiled async chunk's
    busy share; (b) 24 rounds of the async dasha campaign at sigma = 2,
    each round's x held against x_t - gamma (g_t - deficit_t) with the
    in-flight set and the deficit recomputed in float64 from the ring
    (two planted faults, the mask shifted by one slot and the sign
    flipped, must fail), and heap == vec over 40 rounds for dasha and
    marina with fused RandK and dasha with fused QDither (kernel 2): the
    integer traces equal, clocks within 2e-5, metric and x within 1e-4,
    every heap upload decoded against its message; the peak gated at
    phase 15's plus the ring; (c) phase 11's campaign (n = 100,000, C =
    64, the slab store and kernel 4) at tau = 2 and with barriers, 256
    rounds each, the async peak within phase 11's plus 1 GB, and slab ==
    scatter bit for bit at n = 10,000 over 64 rounds at tau 0 and 2.
    ``ASYNC_CUTS`` lists the cuts;
17. campaign telemetry (``repro_torch.obs``) — (a) the heap oracle on
    phase 16's data and links at sigma = 1 with ``Obs.full()``: dasha and
    marina (p = 0.15) with round barriers, dasha at tau = 2 and under the
    tests' FM_MIXED faults, 120 rounds each, and dasha with fused QDither
    (kernel 2) over 40, each run plain and with the handle in turn; gates:
    the two runs bit-identical with no kernel build and equal launches,
    every timeline valid, its per-round byte sums equal to the traced
    bytes, every round blamed once (sync rounds at sync barriers), the
    faulted timeline's crash / drop_up / drop_down / deadline_cut / rejoin
    instants counting what the campaign counts, and two planted faults
    (an upload's bytes plus one, a fault instant removed) failing those
    checks; each timeline written as Perfetto JSON into ``chiprun_out/``;
    (b) the barrier dasha and marina campaigns through VecFedSim, their
    timelines rebuilt by ``reconstruct_vec_timeline`` equal to (a)'s live
    heap timelines event for event, timestamps bit for bit (a timestamp
    moved by one ulp and a dropped event must fail); (c)
    fed_scale_bench's obs gate on phase 12b's campaign (n = 10,000, C =
    64, slab store, kernels 1 and 4), 1,000 rounds, 7 turns of plain /
    ``Obs.metrics_only`` / plain, each turn's order rotated: the handle's
    run against the turn's plain run under 3% (the median over the
    turns; the best of 7 reported), no build,
    every run bit-identical with equal launches, a profiled chunk
    launching as many kernels either way, name for name (the most of
    three windows an arm), the peak within 0.05 GB; then
    phase 11's n = 100,000 campaign with and without the handle over 256
    rounds, reported; (d) the build phase inside
    ``Obs.full().compile_spans()``: one ``backend_compile`` span per
    library that was missing (none on the warm cache), then once more
    into an empty build directory, where every source must be recorded.
    ``OBS_CUTS`` lists the cuts;
18. full-state checkpoints (``repro_torch.checkpoint``) — kill and
    restore through files written under ``tempfile.mkdtemp()`` (each save
    preceded by a free-space check of twice the file's size, every file
    deleted at the end): (a) ``launch.train.train`` with the real flags on
    Mamba2-780M at full width cut to ``CKPT_LAYERS`` of 48 layers (phase
    5's configuration, kernel 3): ``--steps 4`` twice (a control pair that
    tells whether the trainer repeats itself bit for bit on the card),
    ``--steps 2 --ckpt D``, then ``--steps 4 --ckpt D --resume`` from fresh
    objects; gates: the file loads bit for bit into arm 2's final state,
    and the resumed run's final state equals the uninterrupted one's (bit
    for bit when the control pair is; else within the control pair's own
    worst leaf error, never looser than ``CKPT_RESUME_CAP``); (b)
    ``VecFedSim`` on phase 12b's sampled campaign (n = 10,000, C = 64, d
    = 20,958, fused RandK, slab store: kernels 1 and 4), 256 rounds in
    chunks of 32, killed after chunk 3 and restored from disk into a fresh
    simulator; (c) the heap ``FedSim`` on phase 15's data under FM_MIXED
    faults, 40 rounds in chunks of 8, killed after chunk 1; gates for (b)
    and (c): the tail's traces and the final state bit-equal to an
    uninterrupted run's.  Each gate has two planted faults that must fail
    it: a restore with one h_local row one ulp off, and one with the start
    round one off.  Reported: each file's size, save and load seconds and
    GB/s, the device peak and the launches by kernel;
19. the dense GQA family at starcoder2-3b's full width (d_model 3,072, 24
    heads, 2 KV heads, d_ff 12,288, vocab 49,152), with the card's memory
    printed first: (a) ``launch.train.train`` cut to ``DENSE_TRAIN_LAYERS``
    of 30 layers at phase 5's n = 4 x 2 x 512, DASHA-MVR with the fused
    kernel and Adam, rounds/s, tokens/s, peak, busy share; gate: kernel 3
    once per parameter leaf a round (16) and nothing else; (b) serving at
    8 of 30 layers in bf16: ``prefill_logits`` at 4 x 8,192 tokens (the
    streaming attention under the 4,096-token window) beside its bf16
    tensor-core bound, ``serve`` at batch 128, and 32 decode steps at
    batch 128 on the 4,096-slot ring across its wrap beside the bound of
    reading the weights and the cache once; (c) card vs CPU at the three
    smoke configs in float32: prefill logits by the dense (64 tokens) and
    streaming (2,048) paths, 24 decode steps past the 16-slot smoke ring,
    within ``DENSE_AGREE_LIMIT`` (planted: the streaming prefill without
    its window, a ring written at t instead of t % T); (d) starcoder2
    smoke trained on the card and the CPU with the same masks and
    batches, dasha / mvr x kernel off / on (planted: the next round's
    masks; the plain route's launches under (a)'s launch gate); (e)
    Figure 4 (``repro_torch.bench.fig4_dnn``) at 2 of its 120 steps, each
    row with its wall seconds, and dasha_1/32's lowest- and highest-gamma
    lanes against sequential Driver runs (planted: each lane against the
    other's run).  ``DENSE_CUTS`` lists the cuts;
20. gemma3's grouped local/global stack and the mixture-of-experts family,
    with the card's memory printed first: (a-c) served in bf16 at full
    width through ``prefill_logits`` (4 x 8,192 tokens, the streaming
    attention), ``serve`` (one request batch) and 4 decode steps on a
    4,128-slot cache beside their bf16 bounds, each model freed before the
    next: gemma3-12b at 12 of 48 layers (local layers under the 1,024-token
    window, every 6th layer global; decode at batch 32 from t = 4,080,
    the local rings wrapping at 4,096), deepseek-v2-lite-16b at 7 of 27
    (MLA, 64 experts top-6 and 2 shared; decode at batch 128 on the latent
    cache, dropless) and phi3.5-moe at 4 of 32 (16 experts top-2, the
    prefill by both dispatch modes; decode at batch 32); gemma3's prefill
    cut to 2 layers and 2 of its decode steps under the profiler; gate:
    none of the five kernels launches;
    (d) ``launch.train.train`` at the three smoke configs, DASHA-MVR with
    kernel 3 once per parameter leaf a round and nothing else, and one
    forward and backward of deepseek-v2-lite at full width cut to 2
    layers (finite gradients, a non-zero router gradient); (e) card vs
    CPU at the three smoke configs in float32 (prefill by both attention
    paths and both dispatch modes, decode past the local rings' wrap and
    the latent cache's end, trainer rounds on replayed masks) within
    ``DENSE_AGREE_LIMIT`` (planted: rings as long as the sequence, a
    latent cache that never clamps, the next round's masks).
    ``FAMILY_CUTS`` lists the cuts;
21. the hybrid family, zamba2-1.2b (38 Mamba2 layers, d_model 2,048, 64
    SSD heads of 64 with state N = 64, and one shared transformer block
    of 32 heads run before every 6th layer, 7 uses), with the card's
    memory printed first: (a) ``prefill_logits`` at 38 of 38 layers in
    bf16, 4 x 8,192 tokens, beside its bf16 tensor-core bound (gate:
    kernel 5 exactly 38 times a call, no other kernel), and a prefill
    cut to 7 layers (two uses of the shared block) under the profiler:
    device ms by kernel, busy share, kernel 5 a layer against its bytes
    bound; (b) ``serve`` for one batch of 128, a 16-token prompt and 16
    new tokens; (c) 4 decode steps at batch 128 on a 4,128-slot cache
    from t = 4,096, the 7 K/V caches and the SSM states holding random
    history, beside the bound of reading the weights and the cache once
    (gate: none of the five kernels launches while serving); (d) kernel
    5 against its plain version at zamba2's shape (4, 8,192, 64, 64, 64),
    Q = 256, bf16 (the N <= 64 instantiation), its row joining phase 7's;
    (e) card vs CPU at ``zamba2-smoke`` in float32 within
    ``DENSE_AGREE_LIMIT``: prefill logits (64 and 2,048 tokens, kernel 5
    on the card, the plain version on the CPU), decode steps past the
    prompt, trainer rounds on replayed masks with kernel 3 off and on
    (planted: the shared block before the last layer of each period, the
    decode's K/V cache of a use shifted to the next use's, the next
    round's masks); (f) ``launch.train.train`` at ``zamba2-smoke``,
    DASHA-MVR with kernel 3 once per parameter leaf a round and nothing
    else, and one forward and backward at full width cut to 7 layers
    (finite gradients, a non-zero gradient of the shared block).
    ``HYBRID_CUTS`` lists the cuts;
22. the cross-attention families, each cross block's gates set to 0.5
    and -0.3 (they start at zero, where a cross block adds nothing): (a)
    llama-3.2-vision-11b at full width in bf16, 10 of 40 layers (2 of 8
    gated cross blocks to 1,601 image tokens a row): ``prefill_logits`` at
    4 x 8,192 tokens beside its bf16 tensor-core bound, a prefill cut to 5
    layers (one cross block) under the profiler, ``serve`` for one batch,
    4 decode steps at batch 32 on 4,128 slots of random self K/V beside
    the image K/V of each cross block (from ``make_image_kv``), beside the
    bound of reading the weights and both caches once (gate: none of the
    five kernels launches while serving); the smoke trainer, DASHA-MVR with
    kernel 3 once per parameter leaf a round and nothing else; one forward
    and backward at full width cut to 5 layers at 2 x 2,048 (finite
    gradients, non-zero gradients of the gates and of a cross K
    projection); (b) whisper-tiny at full width: ``serve`` at batch 128
    with 1,500 frames through the encoder, a 384-token prompt and 64 new
    tokens (Whisper's 448 positions), no kernel; the trainer at n = 4 x 2
    x 448 tokens with the frames, kernel 3 once per leaf a round, its peak
    reported; (c) card vs CPU at both smoke configs in float32 within
    ``DENSE_AGREE_LIMIT``: prefill logits, 12 decode steps on the cross
    K/V, trainer rounds on replayed masks with kernel 3 (or within 4 x the
    CPU's own half-ulp spread, as 21e), planted: the gates zeroed on the
    card, the VLM's cross block after ``idx % every == 0``, a
    bidirectional whisper encoder, the next round's masks.
    ``CROSS_CUTS`` lists the cuts, ``PHASE22_CUTS`` what earlier phases
    gave up for it;
23. registry compressors on the tree substrate, the sweep's new lanes and
    the seed-era API: (a) the parity bridge at real-sim's shape (phase 3's
    GLM, n = 5, d = 20,958), ``P23_ROUNDS`` rounds of dasha / page /
    marina with fused RandK and dasha with fused QDither, each as a
    single-leaf ``TreeSubstrate`` over ``LeafProblemOracle`` with
    ``SGD(lr=gamma)`` equal to ``FlatSubstrate`` bit for bit (x, g, h_i,
    g_i, bits_sent; planted: a ``LeafSpecCompressor`` that draws a single
    leaf's plan by its path must differ); (b) whisper-tiny's trainer at
    full width built by ``Method.build`` with a registry compressor
    (``make_round_compressor``) on the tree substrate, DASHA-MVR, fused
    Bernoulli (kernel 1 once per leaf a round) and fused QDither (kernel
    2 once per leaf a round), rounds/s and peak; at its smoke config card
    vs CPU on CPU-drawn per-leaf plans (within ``DENSE_AGREE_LIMIT``, or 4
    x the CPU's half-ulp spread; QDither on its ||g||^2 trace, and each of
    its card launches, one a leaf a round, against the plain version by
    phase 2's one-level rule), and the round's own per-leaf plans equal
    to the documented path-seeded ones (planted: every leaf's plan from
    one shared generator must fail that); (c) ``core.dasha.run`` and
    ``core.marina.run`` (marina, vr, vr_online) with ``make_compressor``
    and a fused ``NodeCompressor`` equal to the ``Method.build`` runs bit
    for bit, and ``empirical_omega`` of RandK, PermK and QDither within
    the reference test's bound; (d) sweeps against sequential runs: 8
    lanes of page's p (every coin equal) and 8 lanes of a on fused RandK
    (one kernel-1 launch a round for the 40 rows), each within
    ``P23_LANE_LIMIT``, the lanes' estimator update bit for bit against
    the one-lane updates; 4 lanes of b on the fused MVR tree path at
    starcoder2's smoke config (kernel 3) and 4 lanes on
    ``SampledFlatSubstrate`` (n = 10,000, c = 64), bit for bit; planted: a
    per-row a read at ``row % G`` must fail; (e) kernels 1-3 with per-row
    a / b bit-equal to their plain versions and to one scalar launch a
    lane, timed beside their bounds.  ``PHASE23_CUTS`` lists what earlier
    phases gave up for it;
24. the sharded serving programs (``repro_torch.launch.mesh``,
    ``models.sharding``, ``launch.dryrun``): (a) a one-rank ``nccl`` group
    and ``make_host_mesh("cuda")``: mamba2's and starcoder2's smoke
    configs prefill (kernel 5 through ``local_map``) and take
    ``MESH_DECODE_STEPS`` decode steps on parameters, prompt and cache
    laid out by the policy (``distribute_tree``), bit-equal to the same
    calls on plain tensors on the card, kernel 5's launches in the
    sharded calls counted (planted: a DTensor handed to
    ``ssd_chunk_scan`` without ``local_map`` must raise); (b) in a
    subprocess, rank 0 of the fake 256-rank production mesh on the card:
    ``MESH_PAIRS`` at full width, mamba2-780m x prefill_32k (2 x 32,768
    tokens a rank, 3 of 48 SSM heads, kernel 5 48 times a call) and
    starcoder2-3b x decode_32k (8 rows a rank), the local arguments made
    on the card at their shards' shapes (their bytes must equal the dry
    run's ``argument_gb`` exactly), the peak above the baseline within
    ``MESH_PEAK_BAND`` of the dry run's ``peak_gb``, ms a call beside the
    roofline's per-chip compute and memory terms (the fake group's
    collectives write nothing: outputs unchecked, no collective term in
    the time; a first call over ``MESH_CALL_CUT_S`` cuts the timed call's
    depth, never its width); (c) the same pairs through ``dryrun_one`` in
    that subprocess (trace seconds, peak GB a device, collectives by
    kind).  ``PHASE24_CUTS`` lists what earlier phases gave up for it.
25. the sharded DASHA trainer (``launch.specs.train_spec``'s step on
    DTensors): (a) on a one-rank ``nccl`` host mesh, the smoke configs
    of ``MESH_TRAIN_ARCHS`` (dense, SSM, MLA/MoE, hybrid), 2 rounds of
    DASHA-MVR with kernel 3, and the dense one's 2 rounds of DASHA with
    kernel 1's sparsifier entry (``MESH_TRAIN_CASES``), on injected
    masks, bit-equal to the same step on plain tensors on the card, the
    kernel once per parameter leaf a round counted through ``local_map``
    (planted: a DTensor handed to ``ops.dasha_mvr_update`` without
    ``local_map``, and a mask whose node axis is laid out otherwise than
    h's, must raise and launch nothing); then, in one subprocess and one
    step after the other, nothing else running: (c) each of
    ``MESH_TRAIN_PAIRS`` through ``dryrun_one`` (host-only traces on
    ``meta`` tensors: trace seconds, peak GB a device, collectives by
    kind); (b) rank 0 of the fake 16 x 16 mesh at full width and depth
    for each pair, DashaTrainConfig(gamma=0.01, compression=1/32,
    variant="mvr", use_kernel=True), n = 16 nodes, one node of 16 x
    4,096 tokens a rank, the local state, parameters and batch made on
    the card at their shards' shapes (bytes equal to the dry run's
    ``argument_gb``), one warm-up round and ``MESH_TRAIN_TIMED`` timed,
    the peak above the baseline within ``MESH_PEAK_BAND`` of the dry
    run's ``peak_gb``, kernel 3 once per leaf a round, ms a round beside
    the roofline's per-chip terms (a warm-up over ``MESH_CALL_CUT_S``
    cuts the timed round's depth, never its width), one more round of
    ``MESH_TRAIN_PROFILED``'s pairs under the profiler (the device's busy
    share), and kernel 3 against its plain version at the largest leaf's
    shard.  ``PHASE25_CUTS`` lists what earlier phases gave up for it.

Every phase that drives a main path zeroes the launch counters just before
it and reads them just after; a kernel of that path that never launched
fails the run.  Prints one JSON ``kernels`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import operator
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM5 published peaks (NVIDIA data sheet), with one source: the
# port's roofline, ``repro_torch.launch.roofline.H100_SXM5`` (a copy of
# this script alone, outside a checkout, has none and exits in main)
if (SRC / "repro_torch").is_dir():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.launch.roofline import H100_SXM5 as _CARD
    HBM_BYTES_PER_S, BF16_FLOPS_PER_S = _CARD.hbm_bw, _CARD.peak_flops
    TF32_FLOPS_PER_S, FP32_FLOPS_PER_S = _CARD.tf32_flops, _CARD.fp32_flops
# written between timed launches to evict the 50 MB L2 cache
L2_FLUSH_BYTES = 128 << 20

N_NODES, M_REALSIM, D_REALSIM = 5, 14461, 20958
D_RESNET18 = 11173962
ROUNDS, METRIC_EVERY, K_RANDK, S_QDITHER = 200, 10, 100, 15
SHAPES = [(N_NODES, D_REALSIM), (N_NODES, D_RESNET18), (3, 4099)]
# kernel 2, (shape, misaligned, plan forced): the main paths' widths (the
# flat round's 5 rows, the faulted / async / obs heaps' 20, the cohort's
# 64, fed_bench's 4,096), the ragged misaligned scalar rows, the ResNet-18
# width (two passes), and more rows than a grid's y axis holds, by the
# cluster and the two-pass paths; then the cluster kernels that hold 8
# vectors a thread (float4 at 100,000, scalar at 30,001) and the plans of a
# card that schedules clusters of 8 only ("cluster8")
QUANT_CASES = [((N_NODES, D_REALSIM), False, ""),
               ((20, D_REALSIM), False, ""),
               ((64, D_REALSIM), False, ""),
               ((N_NODES, 4096), False, ""), ((3, 4099), True, ""),
               ((N_NODES, D_RESNET18), False, ""),
               ((65600, 256), False, ""), ((65600, 256), False, "two_pass"),
               ((N_NODES, 100000), False, ""), ((3, 30001), True, ""),
               ((N_NODES, D_REALSIM), False, "cluster8"),
               ((20, D_REALSIM), False, "cluster8"),
               ((N_NODES, 4096), False, "cluster8"),
               ((3, 4099), True, "cluster8")]
# the fused QDither entry, ((n, d), lanes, (n, 1) scale with a zero row,
# plan forced): the flat round, the heaps' 20 rows, 8 lanes of 5 rows on
# (n, d) uniforms, coins, rows too wide for a cluster (two passes) with
# lanes and coins, float4 with 8 vectors a thread, and the flat round by
# the plan of a card that schedules clusters of 8 only
FUSED_CASES = [((N_NODES, D_REALSIM), 0, False, ""),
               ((20, D_REALSIM), 0, False, ""),
               ((N_NODES, D_REALSIM), 8, False, ""),
               ((N_NODES, D_REALSIM), 0, True, ""),
               ((3, 150000), 4, True, ""),
               ((N_NODES, 100000), 0, True, ""),
               ((N_NODES, D_REALSIM), 0, False, "cluster8")]
# (vec, vpt) of the cluster kernels each entry must run in phase 2: at
# least those holding 8 vectors a thread
QUANT_MUST_RUN = {"quantize": {(4, 8), (2, 8), (1, 8)},
                  "dasha_quantize_update": {(4, 8), (2, 8)}}
# the cluster path must be this many times below the two-pass path's
# device time at the main paths' shapes (TURN_SHAPES)
CLUSTER_SPEEDUP_MIN = 2.0
# before and after in one call, in turns (old, new, new, old)
TURN_SHAPES = [(N_NODES, D_REALSIM), (20, D_REALSIM)]
# kernel 1's sparsifier entry, (tag, (rows, cols), support, scale,
# misaligned): the flat round's RandK at d/K, the faulted / async heaps'
# 20 rows with coins, the cohort's 64 rows at d/K * n/C, the sweep's 8
# lanes x 5 nodes on the plan's 5 rows, RandK shared_coords (one index row),
# PermK with its 2 PAD slots, passthrough with coins, a Bernoulli fp32 mask
# on misaligned ragged rows, the tree path's shared bool mask, and the
# ResNet-18 width
SPARSIFY_CASES = [
    ("randk", (N_NODES, D_REALSIM), "randk", "d/K", False),
    ("randk_coins", (20, D_REALSIM), "randk", "coins", False),
    ("cohort", (64, D_REALSIM), "randk", "cohort", False),
    ("lanes_8x5", (8 * N_NODES, D_REALSIM), "randk_lanes", "d/K", False),
    ("shared_coords", (N_NODES, D_REALSIM), "randk_shared", "d/K", False),
    ("permk_pad", (N_NODES, D_REALSIM), "permk", "n", False),
    ("passthrough", (N_NODES, D_REALSIM), "none", "coins", False),
    ("bernoulli", (3, 4099), "mask_f32", "1/p", True),
    ("bool_shared", (4, D_REALSIM), "mask_bool_shared", "1/p",
     False),
    ("randk_resnet18", (N_NODES, D_RESNET18), "randk", "d/K", False)]
# kernel entries that no main path calls: kernel 1's dense-mask entry, the
# counterpart of dasha_update_pallas (the paths call the sparsifier entry)
OFF_PATH_ENTRIES = {"dasha_update"}
# the sparsifier entry must be this many times below the chain it replaced
# (mask build + the dense-mask entry), by summed device time, at TURN_SHAPES
SPARSIFY_SPEEDUP_MIN = 2.0
# the trainer: Mamba2-780M's widths, its tied embedding leaf, n = 4 nodes
TRAIN_NODES, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 16, 2, 512
# 4 timed rounds and one profiled (PR 26: 10 and 2; 6 and 1 from
# ``PHASE22_CUTS``, 4 from ``PHASE25_CUTS``)
TRAIN_WARMUP, TRAIN_ROUNDS, TRAIN_PROFILED = 2, 4, 1
# the trainers' largest leaves: Mamba2-780M's tied embedding, starcoder2-3b's
# embedding (its lm_head is as large)
D_EMBED, D_DENSE_EMBED = 50432 * 1536, 49152 * 3072
MVR_SHAPES = [(TRAIN_NODES, D_REALSIM), (TRAIN_NODES, D_EMBED),
              (TRAIN_NODES, D_DENSE_EMBED), (3, 4099)]
# serving: Mamba2-780M's SSD (H = 48 heads x P = 64, state N = 128, chunk
# 256) at the prefill_32k sequence length, batch cut from 32 to 4; then
# the smoke model's, and ragged shapes (B, S, H, P, N, chunk)
SSD_SHAPES = [(4, 32768, 48, 64, 128, 256), (2, 64, 8, 32, 16, 32),
              (1, 128, 4, 16, 8, 32), (2, 32, 3, 4, 5, 8)]
SSD_LIMIT = 1e-4
PREFILL_BATCH, PREFILL_SEQ, PREFILL_TIMED = 4, 32768, 2
# a 32-token prompt (256, then 128 before phases 22 and 23, 64 before
# phase 25; a Mamba2 step's time does not depend on the position); the
# float32 parity prompt is two of the prefill's 256-token chunks, so the
# check runs at the production chunk and across a chunk boundary
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_PROFILED = 128, 32, 32, 4
PARITY_BATCH, PARITY_PROMPT, PARITY_LIMIT = 2, 512, 5e-3
PROFILE_WARMUP_LAUNCHES, PROFILE_WARMUP_S = 32, 0.2
PROFILE_RETRIES = 2
# the cross-device campaign: fed_scale_bench's largest (n = 10^5 clients,
# C = 64, 1,000 rounds) at real-sim's width, chunks of 128 rounds; and a
# store past 2^31 elements for the kernel's 64-bit offsets
FED_N, FED_C, FED_ROUNDS, FED_CHUNK, FED_BIG_N = 100000, 64, 1000, 128, \
    110000
# the heap oracle: benchmarks/fed_bench.py straggler_curves' links (uplink
# 1e6 B/s with a lognormal straggler, downlink 1e8 B/s, 1 ms latency, no
# compute time, network seed 7) at the real-sim shape, 200 rounds in chunks
# of 128; then the sampled heap campaign at phase 12b's n = 10,000, C = 64
HEAP_ROUNDS, HEAP_SIGMAS, HEAP_SEED = 200, (0.0, 1.0, 2.0), 7
HEAP_UP_BPS, HEAP_DOWN_BPS, HEAP_LATENCY = 1e6, 1e8, 1e-3
HEAP_N, HEAP_SAMPLED_ROUNDS = 10000, 256
# the stepsize sweep (phase 14): benchmarks/fig1_gradient.py's protocol at
# the real-sim shape — dasha and marina (batch 0, p = marina_p(K, d)), 8
# stepsizes gamma_dasha * 2^i as one sweep of 8 lanes, fused RandK K = 100,
# ||grad f||^2 every round; lane equality against sequential Driver runs
# over the first 50 rounds; the peak-memory gate against 6.06 GB of
# features (the lanes outside the nodes would need ~55 GB)
SWEEP_G, SWEEP_ROUNDS, SWEEP_EQ_ROUNDS, SWEEP_EQ_RTOL = 8, 200, 50, 1e-4
SWEEP_PEAK_GB, SWEEP_PROFILED = 8.0, 10
# the lane-equality sweep adds a ninth lane, gamma_dasha * 2^SWEEP_FAST,
# whose iterate moves the node gradients by at least SWEEP_FAST_MOVE of
# their norm in 50 rounds (fig1's 8 lanes move them by ~1e-4 at most);
# each checked lane's final iterate, and the fast lane's h_i, must lie
# within SWEEP_STATE_RTOL of the sequential run's, relative to how far
# that run moved them from x0's state: the gemm-vs-gemv summation order
# leaves ~1.2e-4 there, a lane frozen at x0 or run at its neighbour's
# gamma is ~1 off
SWEEP_FAST, SWEEP_FAST_MOVE, SWEEP_STATE_RTOL = 16, 1e-2, 1e-2
SWEEP_STATE = ("x", "g", "g_local", "h_local")
# the port's figures on the card: fig1, fig5 and table1 at the reference's
# rounds; fig2 at an eighth of its rounds and fig3 at a fortieth (its
# stochastic rounds draw every node's samples on the host: ~4 minutes at
# full length; at half and a tenth they took 54 and 53 s on a slow host,
# at a quarter and a twentieth 17.5 and 20.4 s on a fast one), so that
# the whole script stays inside its time limit with phases 21 and 22
FIG_ROUNDS_SCALE = {"fig1_gradient": 1.0, "fig2_finite_sum": 0.015625,
                    "fig3_stochastic": 0.003125, "fig5_quadratic_pl": 1.0,
                    "table1_complexity": 1.0}
# the faulted campaigns (phase 15): benchmarks/fed_faults_bench.py's
# configuration widened to real-sim's features — n = 20 clients (the
# bench's N) x m = 3,615 samples (72,300 of real-sim's 72,309 rows), d =
# 20,958, fused RandK K = 100, the bench's links, crash process and
# deadline; its drop grid at its 240 rounds, then heap == vec campaigns
# of 40 rounds, and card vs CPU at (n, m, d) = FAULT_SMALL
FAULT_N, FAULT_M, FAULT_ROUNDS, FAULT_EQ_ROUNDS = 20, 3615, 240, 40
FAULT_PEAK_GB, FAULT_SMALL, FAULT_SMALL_K = 8.0, (5, 32, 40), 6
# heap against vec: wall clock (the vec's float32 delays) and metric, the
# reference's tests' tolerances; the reset campaign's server invariant
FAULT_WALL_RTOL, FAULT_METRIC_RTOL, FAULT_INVARIANT = 2e-6, 1e-4, 1e-5
# the faulted DASHA round against the one written out by hand: each row's
# error in units of the most that round could move the row (a dropped
# client's round committed, or a reset missed, is ~1 there)
FAULT_HAND_LIMIT = 1e-3
# asynchronous pipelined rounds (phase 16): benchmarks/fed_async_bench.py's
# configuration widened to real-sim's features as phase 15 widens its own
# (n = 20 clients, the bench's N, x m = 3,615 x d = 20,958), fused RandK K
# = 100, the bench's links, tau = 2, dasha and marina (p = 0.15), barrier
# and async, 300 rounds (the bench's); its tau sweep at sigma = 2 over 150
# rounds; then heap == vec over 40 rounds and phase 11's campaign at tau =
# 2.  ASYNC_CUTS lists what is cut from the bench and from phase 11.
ASYNC_N, ASYNC_TAU, ASYNC_SIGMAS, ASYNC_ROUNDS = 20, 2, (0.0, 1.0, 2.0), 300
ASYNC_CHECK_ROUNDS, ASYNC_EQ_ROUNDS = 24, 40
# 16b: each round's x against x_t - gamma (g_t - deficit_t), the deficit
# recomputed in float64 from the ring: each coordinate within
# ASYNC_DEFICIT_LIMIT x gamma max|deficit_t| plus ASYNC_ULPS float32 ulps
# of the terms the card rounds (|x_t| + gamma |g_t| + gamma |deficit_t|),
# the error reported in units of that bound (a planted fault, which moves
# x by ~gamma max|deficit_t|, is ~1 / ASYNC_DEFICIT_LIMIT there); heap
# against vec
ASYNC_DEFICIT_LIMIT, ASYNC_ULPS = 1e-3, 4
ASYNC_WALL_RTOL, ASYNC_METRIC_RTOL, ASYNC_X_RTOL = 2e-5, 1e-4, 1e-4
# 16a/b's peak: phase 15's (6.35 GB on the H100) plus the (tau, n, d) ring
# and a margin; 16c's: phase 11's (35.02 GB) plus 1 GB, well under the 8.4
# GB an (n, d) deficit transient would add
ASYNC_PEAK_MARGIN_GB, FED_PEAK_GB, ASYNC_PEAK_SLACK_GB = 0.25, 35.02, 1.0
ASYNC_SCALE_ROUNDS, ASYNC_SS_N, ASYNC_SS_ROUNDS = 256, 10000, 64
ASYNC_CUTS = {
    "sigmas": "fed_async_bench's (0, 0.5, 1, 1.5, 2) cut to (0, 1, 2), its "
              "quick grid",
    "equivalence": "fed_async_bench's n = 5, d = 64 replaced by the "
                   "real-sim width, n = 20, 40 rounds",
    "scale_rounds": "phase 11's 1,000 rounds cut to 256 at tau = 2 and "
                    "with barriers",
    "slab_vs_scatter": "n = 10,000 over 64 rounds (phase 12b: 128)",
}
# campaign telemetry (phase 17): 17a/b on phase 16's data (n = 20 x m =
# 3,615 x d = 20,958, fused RandK K = 100) and the async bench's links at
# sigma = OBS_SIGMA, OBS_HEAP_ROUNDS rounds a campaign (the fused QDither
# one OBS_QDITHER_ROUNDS); 17c benchmarks/fed_scale_bench.py's obs gate
# (n = 10,000, C = 64, the handle under 3% of the wall clock) on phase
# 12b's campaign in short campaigns, one chunk of OBS_GATE_ROUNDS rounds
# each (the handle's cost for each campaign weighs 1000 / 32 times what
# it does in the reference's 1,000 rounds; short runs give the median
# more pairs a second, and most of them miss the host's hiccups), run as
# a plain campaign, then OBS_TURNS turns of OBS_TURN (three handle runs
# and a planted one, each followed by a plain run): each handle run and
# each planted run (a handle that
# spins on the host for OBS_PLANTED times the gate of a plain campaign's
# wall) is read against the mean of the plain runs on either side, which
# cancels the host's drift, and the gate is the median of those ratios;
# the planted median must reach the gate; each inner plain run against
# its two plain neighbours is the control (on the H100's host a
# campaign's wall drifts over a minute and spreads from one run to the
# next by more than the gate: a median over 7 turns of 1,000-round runs,
# each against its turn's plain run, read +3.27% once with its control
# at -1.58%, and a median of 60 one-chunk 128-round ratios +3.07% with
# its control at +0.19%), the handle's peak within
# OBS_PEAK_SLACK_GB of the plain runs', a profiled chunk's launches equal
# name for name (each arm the most of OBS_PROFILE_WINDOWS windows: the
# profiler can lose records), and phase 11's n = 100,000 over
# OBS_SCALE_ROUNDS rounds.  OBS_CUTS lists what is cut.
OBS_SIGMA, OBS_HEAP_ROUNDS, OBS_QDITHER_ROUNDS = 1.0, 120, 40
OBS_GATE_ROUNDS, OBS_TURNS, OBS_OVERHEAD, OBS_PLANTED = 32, 60, 0.03, 4.0
OBS_TURN = ("obs", "plain", "obs", "plain", "obs", "plain", "planted",
            "plain")
OBS_SCALE_ROUNDS, OBS_PEAK_SLACK_GB = 128, 0.05
OBS_PROFILE_WINDOWS = 3
OBS_CUTS = {
    "heap_rounds": "17a's campaigns 120 rounds (the async bench: 300)",
    "overhead_width": "fed_scale_bench's gated case (d = 64, m = 2, K = 8) "
                      "widened to phase 12b's d = 20,958, m = 1, K = 100",
    "overhead_rounds": "fed_scale_bench's 1,000 rounds a run cut to one "
                       "chunk of 32, each handle run between two plain "
                       "ones, 180 handle runs",
    "scale_rounds": "phase 11's 1,000 rounds cut to 128 at n = 100,000 "
                    "(256, as 16c, before PHASE25_CUTS)",
}


# full-state checkpoints (phase 18): (a) phase 5's trainer cut to
# CKPT_LAYERS of 48 layers (~92M parameters, ~48 B each in a file: x,
# g, 4 g_i, 4 h_i, Adam's mu and nu), CKPT_STEPS rounds uninterrupted
# against CKPT_CUT, a checkpoint and the rest; the resumed state against
# the uninterrupted one within the control pair's own worst leaf error
# (relative to the leaf's largest magnitude) when the trainer does not
# repeat itself bit for bit, and never looser than CKPT_RESUME_CAP; (b)
# phase 12b's campaign killed after chunk CKPT_VEC_KILL; (c) phase 15's
# faulted heap campaign killed after chunk CKPT_HEAP_KILL
CKPT_LAYERS, CKPT_STEPS, CKPT_CUT, CKPT_RESUME_CAP = 1, 4, 2, 1e-4
CKPT_VEC_ROUNDS, CKPT_VEC_CHUNK, CKPT_VEC_KILL = 256, 32, 3
CKPT_HEAP_ROUNDS, CKPT_HEAP_CHUNK, CKPT_HEAP_KILL = 40, 8, 1
CKPT_CUTS = {
    "trainer_layers": "Mamba2-780M's 48 layers cut to 1 (2 before PR 30's "
                      "PHASE25_CUTS; phase 5: 16), so that each of 4 arms "
                      "and its ~4.4 GB file stay within the phase's time",
    "trainer_steps": "4 rounds, the checkpoint after 2",
}

# the dense GQA family (phase 19): starcoder2-3b at full width (d_model
# 3,072, 24 heads, 2 KV heads, d_ff 12,288, vocab 49,152).  (a) the
# trainer cut to DENSE_TRAIN_LAYERS of 30 layers at phase 5's n = 4 x 2 x
# 512, DASHA-MVR with kernel 3 once per parameter leaf a round
# (DENSE_LEAVES) and an Adam server; (b) serving at 8 of 30 layers in
# bf16: a 4 x 8,192 prefill (two 4,096-token windows: the streaming path
# and its window mask), the serve entry point at batch 128, and
# DENSE_DECODE_STEPS decode steps at batch 128 on the 4,096-slot ring,
# wrapping; (c, d) card against CPU at the three smoke configs in float32
# (prefill by both attention paths, decode past the 16-slot smoke ring,
# trainer rounds on replayed masks) within DENSE_AGREE_LIMIT; (e) Figure 4
# cut from its 120 steps to FIG4_STEPS, dasha_1/32's lanes
# FIG4_CHECKED_LANES against sequential runs (FIG4_LANE_RTOL of each
# field's move from the start,
# FIG4_LOSS_RTOL on the eval loss); a prefill is profiled on
# DENSE_PROFILED_LAYERS of its identical layers
DENSE_LEAVES = 16
DENSE_TRAIN_LAYERS, DENSE_TRAIN_WARMUP, DENSE_TRAIN_ROUNDS = 3, 2, 6
DENSE_SERVE_LAYERS = 8             # of 30 (PHASE25_CUTS)
DENSE_PREFILL_BATCH, DENSE_PREFILL_SEQ, DENSE_PREFILL_TIMED = 4, 8192, 1
DENSE_SERVE_PROMPT, DENSE_SERVE_NEW = 16, 16
DENSE_DECODE_BATCH, DENSE_DECODE_STEPS, DENSE_DECODE_PROFILED = 128, 32, 4
DENSE_AGREE_LIMIT, DENSE_AGREE_STREAM_SEQ = 1e-4, 2048
DENSE_DECODE_AGREE_STEPS, DENSE_AGREE_ROUNDS = 24, 3
FIG4_LANE_RTOL, FIG4_LOSS_RTOL, FIG4_CHECKED_LANES = 1e-2, 1e-3, (0, 2)
# Figure 4's 120 host-bound steps took 95-131 s on the card (40 steps
# 38-51 s, 20 steps 20.3 s); a tenth of them keeps its rows and its lane
# gate at the same count
FIG4_STEPS = 2
DENSE_PROFILED_LAYERS = 2
DENSE_CUTS = {
    "trainer_layers": "starcoder2-3b's 30 layers cut to 3 for the trainer: "
                      "n = 4 nodes of fp32 state and the round's per-node "
                      "trees take ~105 bytes a parameter (53.36 GB at 2 "
                      "layers, 62.19 GB at 3 on the H100, leaving 22.8 GB "
                      "of its 85.0 GB; 4 layers would need ~71 GB)",
    "decode_history": "the 4,096-slot ring filled with random K/V in place "
                      "of 4,096 prompt steps (a step's time does not depend "
                      "on the values)",
    "fig4_steps": "Figure 4 at 2 of its 120 steps (rows and the lane "
                  "gate at the same count), to make room for phases 21 to "
                  "24",
    "prefill_timed": "one timed prefill call after the warm-up (PR 26: "
                     "two), to make room for phase 22",
}

# gemma3's grouped stack and the MoE family (phase 20): each model at full
# width in bf16, (arch, layers served or None for all, decode batch, the
# prefill's dispatch modes);
# prefill FAMILY_PREFILL_BATCH x FAMILY_PREFILL_SEQ, decode steps from
# FAMILY_DECODE_T0 on FAMILY_DECODE_SLOTS slots; the trainer at the smoke
# configs (FAMILY_LEAVES parameter leaves each), the routed backward at
# full width cut to FAMILY_GRAD_LAYERS; card vs CPU at the smoke configs
FAMILY_ARCHS = ("gemma3-12b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b")
FAMILY_RUNS = (("gemma3-12b", 12, 32, (None,)),
               ("deepseek-v2-lite-16b", 7, 128, ("gather",)),
               ("phi3.5-moe-42b-a6.6b", 4, 32, ("gather", "einsum")))
FAMILY_LEAVES = {"gemma3-12b": 20, "phi3.5-moe-42b-a6.6b": 13,
                 "deepseek-v2-lite-16b": 18}
FAMILY_PREFILL_BATCH, FAMILY_PREFILL_SEQ, FAMILY_PREFILL_TIMED = 4, 8192, 1
FAMILY_SERVE_PROMPT, FAMILY_SERVE_NEW = 8, 8
FAMILY_DECODE_SLOTS, FAMILY_DECODE_T0 = 4128, 4080
# two decode steps profiled: the profiler's tables of a 4-step window took
# 7-13 s a model (~4,800 launches a step), for the same busy share
FAMILY_DECODE_STEPS, FAMILY_DECODE_PROFILED = 4, 2
FAMILY_PROFILED_LAYERS = 2
# the profiler's windows and tables took ~64 s of phase 20's 111 s of
# serving with all three models profiled; one model is profiled
FAMILY_PROFILED_ARCH = "gemma3-12b"
FAMILY_TRAIN_ROUNDS = 4
FAMILY_GRAD_LAYERS, FAMILY_GRAD_BATCH, FAMILY_GRAD_SEQ = 2, 2, 2048
FAMILY_AGREE_DECODE_STEPS, FAMILY_AGREE_MLA_SLOTS = 24, 16
FAMILY_AGREE_CHUNK = 48
FAMILY_CUTS = {
    "phi_layers": "phi3.5-moe-42b-a6.6b's 32 layers cut to 16 for serving: "
                  "its 41.87B parameters are 83.7 GB in bf16, more than the "
                  "card's 80 GB; 16 layers are 21.07B, 42.1 GB (4 since PR "
                  "30, PHASE25_CUTS)",
    "decode_history": "the 4,128-slot caches (gemma3's local rings: 1,024 "
                      "slots) filled with random K/V or latents in place of "
                      "4,080 prompt steps (a step's time does not depend on "
                      "the values)",
    "trainer": "the trainer at the three smoke configs: n = 4 nodes of fp32 "
               "state and the round's per-node trees take ~105 bytes a "
               "parameter (62.19 GB at starcoder2's 589.9M, phase 19), so "
               "deepseek-v2-lite cut to 1 of 27 layers (1.00B parameters) "
               "would need ~105 GB, gemma3 and phi3.5-moe more; full width "
               "is one forward and backward of deepseek-v2-lite at 2 layers",
    "prefill_timed": "one timed prefill call after the warm-up (phase 19 "
                     "times two)",
    "profiles": "the prefill and decode profiled for gemma3-12b only, to "
                "make room for phase 21",
}

# the hybrid family (phase 21): zamba2-1.2b at full width and depth in
# bf16, a HYBRID_PREFILL_BATCH x HYBRID_PREFILL_SEQ prefill (kernel 5 on
# each of its 38 Mamba2 layers), a profiled prefill cut to
# HYBRID_PROFILED_LAYERS layers (two uses of the shared block), serve for
# one batch, phase 20's decode steps and slots from HYBRID_DECODE_T0;
# kernel 5 at zamba2's SSD shape; the trainer
# at the smoke config (HYBRID_LEAVES parameter leaves), the full-width
# backward cut to HYBRID_GRAD_LAYERS; card vs CPU at the smoke config
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PREFILL_BATCH, HYBRID_PREFILL_SEQ, HYBRID_PREFILL_TIMED = 4, 8192, 1
HYBRID_PROFILED_LAYERS = 7
HYBRID_SERVE_BATCH, HYBRID_SERVE_PROMPT, HYBRID_SERVE_NEW = 128, 16, 16
HYBRID_DECODE_BATCH, HYBRID_DECODE_T0 = 128, 4096
HYBRID_SSD_SHAPE = (4, 8192, 64, 64, 64, 256)
HYBRID_LEAVES, HYBRID_TRAIN_ROUNDS = 22, 4
HYBRID_GRAD_LAYERS, HYBRID_GRAD_BATCH, HYBRID_GRAD_SEQ = 7, 2, 2048
HYBRID_AGREE_STEPS = 24
# the smoke trainer's card-vs-CPU gate: DENSE_AGREE_LIMIT, or
# HYBRID_CONTROL_FACTOR times the model's own spread, whichever is larger;
# the spread is the CPU run's from parameters nudged by half a float32
# ulp (zamba2-smoke amplifies rounding: on the H100 machine's CPU such a
# nudge moved its trainer states by 3.8e-4 of a leaf's largest
# magnitude, and the card's run differed from the CPU's by 1.7e-4)
HYBRID_CONTROL_FACTOR, HALF_ULP_F32 = 4.0, 2.0 ** -24
HYBRID_CUTS = {
    "decode_history": "the 4,128-slot K/V caches of the 7 shared-block uses "
                      "and the 38 SSM states and conv windows filled with "
                      "random values in place of 4,096 prompt steps (a "
                      "step's time does not depend on the values)",
    "trainer": "the trainer at zamba2-smoke: n = 4 nodes of fp32 state and "
               "the round's per-node trees take ~105 bytes a parameter "
               "(62.19 GB at starcoder2's 589.9M, phase 19), ~116 GB at "
               "zamba2's 1.10B; full width is one forward and backward cut "
               "to 7 of 38 layers (two uses of the shared block)",
    "profiled_prefill": "the profiled prefill cut to 7 of 38 layers",
    "prefill_timed": "one timed prefill call after the warm-up (PR 26: "
                     "two), to make room for phase 22",
}

# the cross-attention families (phase 22): llama-3.2-vision-11b at full
# width in bf16 (CROSS_SERVE_LAYERS of 40 layers, 1,601 image tokens,
# every cross block's gates at CROSS_GATES: they start at zero, where a
# cross block adds nothing): a CROSS_PREFILL_BATCH x CROSS_PREFILL_SEQ
# prefill, a profiled prefill cut to CROSS_PROFILED_LAYERS layers (one
# cross block), serve for one batch, phase 20's decode steps and slots at
# CROSS_DECODE_BATCH; its smoke trainer (CROSS_LEAVES parameter leaves)
# and the full-width backward cut to CROSS_GRAD_LAYERS; whisper-tiny at
# full width: serve at WHISPER_SERVE_BATCH up to Whisper's 448 positions,
# the trainer at n = 4 x 2 x WHISPER_TRAIN_SEQ tokens with 1,500 frames;
# card vs CPU at both smoke configs (CROSS_AGREE_STEPS decode steps,
# CROSS_AGREE_ROUNDS trainer rounds)
CROSS_VLM, CROSS_AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
CROSS_SERVE_LAYERS = 10            # of 40, 2 cross blocks (PHASE25_CUTS)
CROSS_GATES = (0.5, -0.3)
CROSS_LEAVES = {CROSS_VLM: 23, CROSS_AUDIO: 36}
CROSS_PREFILL_BATCH, CROSS_PREFILL_SEQ, CROSS_PROFILED_LAYERS = 4, 8192, 5
CROSS_SERVE_BATCH, CROSS_SERVE_PROMPT, CROSS_SERVE_NEW = 4, 8, 8
CROSS_DECODE_BATCH, CROSS_TRAIN_ROUNDS = 32, 4
CROSS_GRAD_LAYERS, CROSS_GRAD_BATCH, CROSS_GRAD_SEQ = 5, 2, 2048
WHISPER_SERVE_BATCH, WHISPER_SERVE_PROMPT, WHISPER_SERVE_NEW = 128, 384, 64
WHISPER_TRAIN_SEQ, WHISPER_TRAIN_WARMUP, WHISPER_TRAIN_ROUNDS = 448, 2, 2
CROSS_AGREE_STEPS, CROSS_AGREE_ROUNDS = 12, 2
CROSS_CUTS = {
    "vlm_trainer": "the VLM's trainer at its smoke config: n = 4 nodes of "
                   "fp32 state and the round's per-node trees take ~105 "
                   "bytes a parameter (62.19 GB at starcoder2's 589.9M, "
                   "phase 19), ~1.2 TB at 11.52B; full width is one forward "
                   "and backward cut to 5 of 40 layers (one cross block)",
    "decode_history": "the 4,128-slot self K/V caches filled with random "
                      "values in place of 4,080 prompt steps (a step's time "
                      "does not depend on the values); the image K/V made "
                      "by make_image_kv from random image embeddings",
    "prefill_timed": "one timed prefill call after a warm-up cut to 5 "
                     "layers; the decode not profiled",
    "profiled_prefill": "the profiled prefill cut to 5 of 40 layers",
}
# what the earlier phases gave up for phase 22, each beside its seconds
# in PR 26's run 4 (per-unit time x units cut)
PHASE22_CUTS = {
    "phase 5": "6 timed rounds of 10 (4 x 0.978 s) and 1 profiled round of "
               "2 (1.88 s of window, and its tables)",
    "phase 8": "a 128-token serve prompt of 256 (128 x 50.93 ms)",
    "phase 14": "fig2 at 1/8 of its rounds (1/4: 17.53 s), fig3 at 1/40 "
                "(1/20: 20.35 s)",
    "phase 19": "Figure 4 at 12 steps of 20 (8 x 1.017 s), one timed "
                "prefill of 2 (3.40 s), one profiled trainer round of 2 "
                "(0.33 s of window)",
    "phase 21": "one timed prefill of 2 (1.70 s)",
}

# phase 23: registry compressors on the tree substrate, the sweep's new
# lanes and the seed-era API.  A flat lane's oracle on the real-sim GLM is
# a matrix product, (m, d) @ (d, G), where a run takes matrix-vector
# products, so a flat lane of p or a agrees with its run to rounding, not
# bit for bit, and the rounds amplify that rounding (RandK scales each
# kept coordinate by d/K = 209.6).  After 12 rounds on an H100 80GB HBM3
# at 700 W the lanes of p sat 5.39e-4 and those of a 2.39e-3 of a field's
# largest magnitude off their runs, the same on the dense backend; so each
# field is held within P23_LANE_LIMIT of its largest magnitude (measured
# against the run's move, phase 14's gate, PAGE's h_i was 0.12 off).  The
# kernel's per-row a is held bit for bit by the one-round update gate.
# The sampled lanes (an m = 1 problem) and the tree lanes (an oracle that
# takes each lane on its own) are held bit for bit.
P23_ROUNDS, P23_SEED_ROUNDS, P23_SWEEP_ROUNDS = 50, 20, 12
P23_TRAIN_WARMUP, P23_TRAIN_ROUNDS, P23_AGREE_ROUNDS = 1, 2, 2
P23_P_LANES = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)
P23_A_LANES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.8)  # 23e's rows
# 23d's lanes of a: the theory's a = 1 / (2 omega + 1) times 2^-3 .. 2^4
# (a at 0.01-0.8, 4-330 x the theory's, diverged, and its lanes sat 1.6
# of a field's largest magnitude off their runs on the H100)
P23_A_POWERS = range(-3, 5)
P23_B_LANES = (0.05, 0.2, 0.5, 0.9)
P23_SAMPLED = (10000, 64, 4)            # n, c, lanes
P23_LANE_LIMIT = {"p": 1e-3, "a": 5e-3}
# the reference test's bound: E||C(x)-x||^2 / ||x||^2 <= omega * tol + 0.05
P23_OMEGA_TOL = {"randk": 1.25, "permk": 1.25, "qdither": 1.0}
P23_OMEGA_TRIALS = 256
# what the earlier phases gave up for phase 23, each beside its reckoning
# from two whole runs on slower H100 80GB HBM3 hosts at 700 W (1,102.1 and
# 1,136.4 s of command, phase 23 31.0 and 34.7 s; the later one, "slow
# host" below, after phase 14's cut): a margin under the 1,200 s limit
# for slower hosts.  Phase 17d's cold build of all three libraries (17.90
# s there) is kept whole; phase 23's sweeps pay part of it by running no
# dense-backend control
PHASE23_CUTS = {
    "phase 8": "a 64-token serve prompt of 128 and 32 new tokens of 64 "
               "(64 x 65.78 + 32 x 60.75 ms = 6.15 s, slow host)",
    "phase 19": "Figure 4 at 8 steps of 12 (4 of the slow host's 12 "
                "steps in 19.41 s: ~6.5 s)",
    "phase 20": "8 + 8 serve tokens of 16 + 16 and 16 decode steps of 32 "
                "(the three models' ms a step: 5.70 + 6.46 = 12.16 s, "
                "slow host)",
    "phase 23": "its sweeps at 12 rounds of 20 (~4 s of the slow host's "
                "13.02) "
                "and its full-width trainer's 2 timed rounds of 3 (~2 s)",
    "phase 14": "fig2 at 1/16 of its rounds (1/8: 10.50 s) and fig3 at "
                "1/80 (1/40: 11.26 s); neither is gated, their rows are "
                "printed",
}

# the sharded serving programs (phase 24): 24a the smoke configs on a
# one-rank host mesh, bit for bit the plain calls; 24b / 24c rank 0 of the
# fake 16 x 16 production mesh at full width, in a subprocess (a process
# group is global to its process), against the dry run's memory
MESH_ARCHS = ("mamba2-780m", "starcoder2-3b")
MESH_PAIRS = (("mamba2-780m", "prefill_32k"), ("starcoder2-3b", "decode_32k"))
MESH_SMOKE_BATCH, MESH_SMOKE_SEQ, MESH_DECODE_STEPS = 2, 64, 4
MESH_PEAK_BAND, MESH_CALL_CUT_S = (0.75, 1.25), 20.0
# what the earlier phases gave up for phase 24 (~30-45 s), each beside its
# reckoning from earlier whole runs on H100 80GB HBM3 hosts at 700 W;
# none of them removes a counted launch (Figure 4's lanes and fig2 / fig3
# are not main-path runs, and no kernel launches while those models
# decode), so kernels 1-4 launch as before and kernel 5 adds 24a's and
# 24b's
PHASE24_CUTS = {
    "phase 19": "Figure 4 at 4 steps of 8 (the slow host's 4 steps of 12 "
                "took ~6.5 s)",
    "phase 14": "fig2 at 1/32 of its rounds (1/16: 10.50 s on the slow "
                "host) and fig3 at 1/160 (1/80: 11.26 s): ~10.9 s",
    "phases 20-22": "8 decode steps of 16 (FAMILY_DECODE_STEPS, which "
                    "phases 21 and 22 read too) for gemma3, deepseek, "
                    "phi3.5-moe, zamba2 and the VLM: 8 x their summed "
                    "~0.6 s a step, ~5 s",
}


# the sharded DASHA trainer (phase 25): 25a the smoke trainers of the
# dense, SSM, MLA/MoE and hybrid families on a one-rank host mesh,
# MESH_TRAIN_ROUNDS rounds of DASHA-MVR with kernel 3 through local_map on
# injected masks, bit for bit the plain-tensor trainer; 25b / 25c rank 0 of
# the fake 16 x 16 mesh at full width and depth for MESH_TRAIN_PAIRS
# (one node of 16 x 4,096 tokens a data rank), one warm-up round and
# MESH_TRAIN_TIMED timed rounds, against the dry run's memory; a pair
# whose dry run reckons rank 0 above MESH_TRAIN_FIT_GB is recorded and
# not run
MESH_TRAIN_ARCHS = ("starcoder2-3b", "mamba2-780m", "deepseek-v2-lite-16b",
                    "zamba2-1.2b")
# 25a's trainers: DASHA-MVR on every family above, and DASHA (kernel 1's
# sparsifier entry on local shards) on the dense one
MESH_TRAIN_CASES = tuple((a, "mvr") for a in MESH_TRAIN_ARCHS) + \
    (("starcoder2-3b", "dasha"),)
MESH_TRAIN_KERNEL = {"mvr": "dasha_mvr_update",
                     "dasha": "dasha_sparsify_update"}
MESH_TRAIN_ROUNDS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 2, 64
MESH_TRAIN_PAIRS = (("mamba2-780m", "train_4k"), ("starcoder2-3b",
                                                  "train_4k"))
MESH_TRAIN_TIMED, MESH_TRAIN_FIT_GB = 1, 70.0
# 25b's pairs with one more round under the profiler (device activity
# only) after the timed one, for the device's busy share
MESH_TRAIN_PROFILED = ("mamba2-780m",)
# what the earlier phases gave up for phase 25, each beside its reckoning
# from earlier whole runs on H100 80GB HBM3 hosts at 700 W; none removes
# a counted launch of kernels 1, 2, 4 or 5 (Figure 4's lanes and fig2 /
# fig3 are not main-path runs, no kernel launches while those models
# decode, and 17's n = 100,000 comparison is not counted), so those launch
# as before, kernel 1 adding 25a's DASHA trainer; kernel 3 adds 25a's and
# 25b's and gives up phase 5's two rounds
PHASE25_CUTS = {
    "phase 14": "fig2 at 1/64 of its rounds (1/32: ~5.2 s on the slow "
                "host) and fig3 at 1/320 (1/160: ~5.6 s): ~5.4 s",
    "phase 19": "Figure 4 at 2 steps of 4 (the slow host's 4 steps of 12 "
                "took ~6.5 s, ~1.6 s a step): ~3.2 s; starcoder2-3b served "
                "at 8 of 30 layers (DENSE_SERVE_LAYERS; its serve step "
                "took 30.5 s on run 4's host, 20.4 s at 15 on run 7's): "
                "~18 s",
    "phases 20-22": "4 decode steps of 8 (FAMILY_DECODE_STEPS) for gemma3, "
                    "deepseek, phi3.5-moe, zamba2 and the VLM: 4 x their "
                    "summed ~0.6 s a step, ~2.4 s",
    "phase 20": "gemma3-12b served at 12 of 48 layers (two of its eight "
                "groups of five local layers and a global one; its serve "
                "step took 23.0 s at 48, 17.6 s at 24 on run 7's host), "
                "deepseek-v2-lite at 7 of 27 (10.6 s at 27) and "
                "phi3.5-moe at 4 of 32 (14.6 s at 16): ~35 s",
    "phase 18": "18a's trainer at 1 of 48 layers (CKPT_LAYERS; 2 before: "
                "a 5.124 GB file saved in 8.62 s and loaded in 15.47 s on "
                "run 4's host), its 13 leaves and counted rounds "
                "unchanged: ~6 s",
    "phase 22": "llama-3.2-vision-11b served at 10 of 40 layers, 2 of 8 "
                "cross blocks (CROSS_SERVE_LAYERS; its prefill took 7.56 "
                "s at 40): ~9 s",
    "phase 5": "4 timed rounds of 6 (TRAIN_ROUNDS; 1.46 s a round on run "
               "8's host, kernel 3's 26 launches fewer): ~3 s",
    "phase 8": "a 32-token decode prompt of 64 (DECODE_PROMPT; 68.76 ms "
               "a prompt step at batch 128 on run 8's host): ~2.2 s",
    "phase 17": "the n = 100,000 metrics-only comparison at 128 rounds of "
                "256 (OBS_SCALE_ROUNDS; three runs at ~140 rounds/s, no "
                "gate, no counted launch): ~2.7 s; and, no cut, 17c's six "
                "profiled windows of ~10,400 device records each read "
                "from the profiler's raw records rather than its event "
                "tree (the same records by name and start)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_kernels(torch, prof, raw: bool = False):
    """Device time (us) and count of every CUDA kernel in a profile, but
    the warm-up's spin kernels.  ``raw`` sums the profiler's device
    events by name without building its event tree (the same table, in
    less time)."""
    from torch.autograd import DeviceType
    out = {}
    if raw:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and \
                    "spin_kernel" not in e.name():
                c, us = out.get(e.name(), (0, 0.0))
                out[e.name()] = (c + 1, us + e.duration_ns() / 1e3)
        return out
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = (e.count, float(us))
    return out


def profiled(torch, fn, cpu: bool = True):
    """Run ``fn`` under torch.profiler: (kernel table, wall seconds).  The
    profiler records no launch of its first moments (without a warm-up, a
    window of one call recorded none, and one of 20 short calls 13), so
    a few spin kernels and a pause come first, outside the wall and the
    table.  ``cpu=False`` records the device activity only and sums its
    events by name: the host's op events and the profiler's event tree
    are most of what the tables take to build (a window of 20,364
    launches took 31 s with them, 16 s with the tree alone)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_WARMUP_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_kernels(torch, prof, raw=not cpu), wall


def kernel_device_ms(torch, fn, names, reps: int = 20,
                     retries: int = PROFILE_RETRIES):
    """Device time of one call of ``fn`` from the profiler: the summed
    time of the CUDA kernels whose names contain one of ``names``.  A
    profiled single call gives the launches a call makes, and the
    ``reps``-call window must hold exactly ``reps`` times as many (a window
    that missed launches measures nothing): such a window is profiled
    again, at most ``retries`` times, each attempt logged, before the
    result is None."""
    fn()
    torch.cuda.synchronize()

    def matching(table):
        hits = [(c, t) for k, (c, t) in table.items()
                if any(nm in k for nm in names)]
        return sum(c for c, _ in hits), sum(t for _, t in hits)

    def run():                       # keeps no outputs alive between calls
        for _ in range(reps):
            fn()

    per_call, _ = matching(profiled(torch, fn)[0])
    for attempt in range(1 + retries):
        table, _ = profiled(torch, run)
        n, us = matching(table)
        if per_call > 0 and n == per_call * reps:
            if attempt:
                log(f"[profile] {names}: attempt {attempt + 1} recorded "
                    f"all {n} launches")
            return us / reps / 1e3
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"[profile] {names}: attempt {attempt + 1} of {1 + retries}: "
            f"{per_call} launches in one profiled call, {n} in {reps} "
            f"calls; {len(table)} kernels recorded, the longest "
            f"{[(k[:60], c, t) for k, (c, t) in top]}")
        if per_call == 0:
            per_call, _ = matching(profiled(torch, fn)[0])
    log(f"[profile] {names}: no device time after {1 + retries} attempts")
    return None


def sass_mma_count(name: str):
    """HMMA/HGMMA instructions (tensor-core products) in the SASS of the
    built ``csrc/<name>.cu``, from ``cuobjdump -sass``; None, with the
    reason, where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"hmma": None, "hgmma": None,
                "note": "no cuobjdump in this toolkit"}
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    ops = re.findall(r"\b(HMMA|HGMMA)\.", sass)
    return {"hmma": ops.count("HMMA"), "hgmma": ops.count("HGMMA"),
            "note": None}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(torch, shape, seed: int, misalign: bool):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    numel = math.prod(shape)

    def make(fill):
        off = 1 if misalign else 0
        buf = torch.empty(numel + off, device="cuda")
        fill(buf)
        return buf[off:].view(shape)

    grad = make(lambda b: b.normal_(generator=g))
    h = make(lambda b: b.normal_(generator=g))
    gl = make(lambda b: b.normal_(generator=g))
    mask = make(lambda b: b.copy_((torch.rand(b.shape, device="cuda",
                                               generator=g) < 0.3).float()))
    u = make(lambda b: b.uniform_(generator=g))
    return grad, h, gl, mask, u


def _check_dasha(torch, kern, ref, shape, misalign, seed):
    """Kernel 1's dense-mask entry against its plain version at the flat
    round's RandK scale d/K on a Bernoulli mask: bit-equal and
    repeatable."""
    a, scale = 1.0 / (2.0 * 208.58 + 1.0), 209.58
    grad, h, gl, mask, _ = _inputs(torch, shape, seed, misalign)
    out = kern.dasha_update(grad, h, gl, mask, a, scale)
    again = kern.dasha_update(grad, h, gl, mask, a, scale)
    plain = ref.dasha_update_ref(grad, h, gl, mask, a, scale)
    torch.cuda.synchronize()
    err = max(float((o - p).abs().max()) for o, p in zip(out, plain))
    if err != 0.0 or not all(torch.equal(o, p) for o, p in zip(out, again)):
        raise AssertionError(f"dasha_update {shape}: max_abs_err {err} "
                             "(must be bit-equal and repeatable)")
    numel = math.prod(shape)
    b, by = bound(7 * 4 * numel, 6 * numel)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale)),
            "plain_ms": time_ms(torch, lambda: ref.dasha_update_ref(
                grad, h, gl, mask, a, scale)),
            "device_ms": kernel_device_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale), ["dasha_update_"]),
            "bound_ms": b, "bound_by": by}


def _check_mvr(torch, kern, ref, shape, misalign, seed):
    """Kernel 3 against its plain version on every mask form: the fp32
    mask, the trainer's bool draw and one shared bool row (read at r % 1),
    for MVR and SARAH (b = 0), bit-equal and repeatable.  Timed on the
    bool mask the trainer hands it (29 bytes an element), the fp32 mask's
    times (32 bytes) beside them."""
    a, scale = 1.0 / (2.0 * 31.0 + 1.0), 32.0
    gn, h, gl, mask, _ = _inputs(torch, shape, seed, misalign)
    go, *_ = _inputs(torch, shape, seed + 50, misalign)
    bmask = mask != 0
    masks = {"float32": mask, "bool": bmask,
             "bool_shared": bmask[:1].contiguous()}
    err = 0.0
    for form, mk in masks.items():
        for b in (0.1, 0.0):                  # MVR and SARAH (SYNC-MVR)
            out = kern.dasha_mvr_update(gn, go, h, gl, mk, a, b, scale)
            again = kern.dasha_mvr_update(gn, go, h, gl, mk, a, b, scale)
            plain = ref.dasha_mvr_update_ref(gn, go, h, gl, mk, a, b, scale)
            torch.cuda.synchronize()
            err = max([err] + [float((o - p).abs().max())
                               for o, p in zip(out, plain)])
            if err != 0.0 or not all(torch.equal(o, p)
                                     for o, p in zip(out, again)):
                raise AssertionError(f"dasha_mvr_update {shape} {form} "
                                     f"b={b}: max_abs_err {err} (must be "
                                     "bit-equal and repeatable)")
            del out, again, plain
    numel = math.prod(shape)

    def timed(mk, nbytes):
        b_ms, by = bound(nbytes * numel, 9 * numel)
        return {"ms": time_ms(torch, lambda: kern.dasha_mvr_update(
                    gn, go, h, gl, mk, a, 0.1, scale)),
                "plain_ms": time_ms(torch, lambda: ref.dasha_mvr_update_ref(
                    gn, go, h, gl, mk, a, 0.1, scale)),
                "device_ms": kernel_device_ms(
                    torch, lambda: kern.dasha_mvr_update(
                        gn, go, h, gl, mk, a, 0.1, scale),
                    ["dasha_mvr_update_"]),
                "bound_ms": b_ms, "bound_by": by}
    return {"max_abs_err": err, "mask": "bool", **timed(bmask, 29),
            "float32_mask": timed(mask, 32)}


QUANT_NAMES = ["quantize_cluster", "quantize_partials", "quantize_apply"]
TWO_PASS_NAMES = ["quantize_partials", "quantize_apply"]


def _plan_of(kern, force: str, rows: int, cols: int, tensors):
    """Kernel 2's plan for a case: ``quantize_plan``'s on this card (""),
    the two-pass plan ("two_pass"), or the cluster plan of a card that
    schedules clusters of 8 only ("cluster8")."""
    a16, a8 = kern._aligned(tensors, 16), kern._aligned(tensors, 8)
    if force == "two_pass":
        return kern.quantize_two_pass_plan(rows, cols, a16, a8)
    if force == "cluster8":
        plan = kern.quantize_plan(rows, cols, a16, a8, 8)
        if plan.two_pass or plan.blocks_per_row != 8:
            raise AssertionError(f"({rows}, {cols}): {plan} is not a "
                                 "cluster of 8")
        return plan
    return kern._plan_for(rows, cols, tensors)


def _check_quantize(torch, kern, ref, shape, misalign, seed, force=""):
    """Kernel 2's plain entry against its plain version by the one-level
    rule, two launches bit-identical; by ``quantize_plan``, or a plan
    forced through the private entry (:func:`_plan_of`)."""
    levels = S_QDITHER
    grad, _, _, _, u = _inputs(torch, shape, seed, misalign)
    x = grad.clone()
    if misalign:
        x[0].zero_()                       # a zero row quantizes to zeros
    plan = _plan_of(kern, force, shape[0], shape[1], (x, u))

    def launch():
        return kern._quantize_with_plan(x, u, levels, plan)
    q = launch()
    q_again = launch()
    q_plain = ref.quantize_ref(x, u, levels)
    torch.cuda.synchronize()
    agree = kern.quantize_agreement(q, q_plain, x, u, levels)
    if not agree["ok"] or not torch.equal(q, q_again):
        raise AssertionError(f"quantize {shape} {plan}: {agree} (one-level "
                             "rule and repeatability)")
    if misalign and bool(q[0].abs().max() != 0):
        raise AssertionError("quantize: a zero row must give zeros")
    del q, q_again, q_plain
    numel = math.prod(shape)
    b, by = bound(3 * 4 * numel, 10 * numel)
    return {"entry": "quantize", "forced": force, "plan": plan._asdict(),
            "max_abs_err": agree["max_abs_err"],
            "one_level_flips": agree["flips"],
            "ms": time_ms(torch, launch),
            "plain_ms": time_ms(torch, lambda: ref.quantize_ref(x, u,
                                                                 levels)),
            "device_ms": kernel_device_ms(torch, launch, QUANT_NAMES),
            "bound_ms": b, "bound_by": by}


def _coin_scale(torch, n: int):
    """An (n, 1) participation scale 1 / p' = 2 with node 1 sitting the
    round out (scale 0)."""
    s = torch.full((n, 1), 2.0, device="cuda")
    s[min(1, n - 1)] = 0.0
    return s


def _bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _check_fused_quantize(torch, kern, ref, shape, lanes, coins, seed,
                          force="", a=0.0371):
    """The fused QDither entry against the chain it replaces: (lanes, n, d)
    rows (lanes 0: (n, d)) with (n, d) uniforms and a float scale or an (n,
    1) one with a zero row; by ``quantize_plan``, or a plan forced through
    the private entry (:func:`_plan_of`).  Gates: h_out is h_new; two launches
    bit-identical; delta exact (the plain entry on the torch chain's delta,
    by the fused entry's own plan, gives its m bit for bit); m by the
    one-level rule scaled by the scale; g_new == g_local + m bit for bit."""
    levels = S_QDITHER
    n, d = shape
    full = (lanes, n, d) if lanes else (n, d)
    rows = math.prod(full[:-1])
    hn, h, gl, _, _ = _inputs(torch, full, seed, False)
    _, _, _, _, u = _inputs(torch, (n, d), seed + 1, False)
    scale = _coin_scale(torch, n) if coins else 1.0
    forced = _plan_of(kern, force, rows, d, (hn, h, gl, u)) if force \
        else None

    def launch():
        return kern._dasha_quantize_update_with_plan(hn, h, gl, u, a, scale,
                                                     levels, forced)
    m, h_out, g_new = launch()
    m2, _, g2 = launch()
    used = forced or kern._plan_for(rows, d, (hn, h, gl, u, m, g_new))
    pm, _, _ = ref.dasha_quantize_update_ref(hn, h, gl, u, a, scale, levels)
    delta = (hn - h - a * (gl - h)).reshape(rows, d)
    sc = scale if not coins else \
        scale.expand(full[:-1] + (1,)).reshape(rows, 1)
    q = kern._quantize_with_plan(delta.contiguous(), u, levels, used)
    uu = u.expand(full).reshape(rows, d)
    agree = kern.quantize_agreement(m.reshape(rows, d), pm.reshape(rows, d),
                                    delta, uu, levels, scale=sc)
    torch.cuda.synchronize()
    tag = f"dasha_quantize_update {full} coins={coins} {used}"
    if h_out is not hn:
        raise AssertionError(f"{tag}: h_out is not h_new")
    if not (torch.equal(m, m2) and torch.equal(g_new, g2)):
        raise AssertionError(f"{tag}: two launches differ")
    if not _bits_equal(torch, m.reshape(rows, d), q * sc):
        raise AssertionError(f"{tag}: delta is not the chain's bit for bit "
                             "(m != the plain entry on the chain's delta)")
    if not agree["ok"]:
        raise AssertionError(f"{tag}: m against the plain chain: {agree}")
    if not _bits_equal(torch, g_new, gl + m):
        raise AssertionError(f"{tag}: g_new != g_local + m")
    if coins and bool(m[..., 1, :].abs().max() != 0):
        raise AssertionError(f"{tag}: a zero-scale node sent a message")
    del m, m2, g2, h_out, g_new, pm, delta, q, uu
    b, by = bound(4 * (5 * rows * d + n * d), 16 * rows * d)
    return {"entry": "dasha_quantize_update", "lanes": lanes, "coins": coins,
            "forced": force, "plan": used._asdict(), "max_abs_err": agree["max_abs_err"],
            "one_level_flips": agree["flips"],
            "ms": time_ms(torch, launch),
            "plain_ms": time_ms(torch, lambda: ref.dasha_quantize_update_ref(
                hn, h, gl, u, a, scale, levels)),
            "device_ms": kernel_device_ms(torch, launch, ["dasha_quantize_"]),
            "bound_ms": b, "bound_by": by}


def _turns(torch, old, new):
    """Device ms of two versions in turns (old, new, new, old), each
    ``(fn, names)``."""
    seq = [kernel_device_ms(torch, *arm) for arm in (old, new, new, old)]
    return {"old_ms": [seq[0], seq[3]], "new_ms": [seq[1], seq[2]]}


def _turn_ratio(tag: str, t: dict) -> float:
    """Old over new mean device ms of a :func:`_turns` result, stored in it
    as ``ratio``; fails where a turn read no device time."""
    old = [v for v in t["old_ms"] if v is not None]
    new = [v for v in t["new_ms"] if v is not None]
    if len(old) < 2 or len(new) < 2:
        raise AssertionError(f"[kernels] {tag}: no device time in a turn "
                             f"{t}")
    t["ratio"] = statistics.mean(old) / statistics.mean(new)
    log(f"[kernels] {tag}: old {old} ms, new {new} ms, old/new "
        f"{t['ratio']:.2f}")
    return t["ratio"]


def _gate_speedup(tag: str, t: dict) -> None:
    """The cluster path at least :data:`CLUSTER_SPEEDUP_MIN` times below
    the two-pass path in the same turns."""
    if _turn_ratio(tag, t) < CLUSTER_SPEEDUP_MIN:
        raise AssertionError(f"[kernels] {tag}: two-pass / cluster "
                             f"{t['ratio']:.2f} < {CLUSTER_SPEEDUP_MIN}")


def _quantize_turns(torch, kern, shape, seed, plant: bool = False):
    """At a main path's shape: the cluster path against the two-pass path
    (forced through the private entry), gated by :func:`_gate_speedup`,
    and the fused entry against the unfused chain it replaced (torch delta,
    two-pass quantize, * scale, + g_local) as one device-time sum.  With
    ``plant``, the gate must also refuse the two-pass path timed as the
    new arm."""
    levels, a, scale = S_QDITHER, 0.0371, 1.0
    hn, h, gl, _, u = _inputs(torch, shape, seed, False)
    x = hn.clone()
    two = kern.quantize_two_pass_plan(*shape, kern._aligned((x, u), 16),
                                      kern._aligned((x, u), 8))
    if kern._plan_for(*shape, (x, u)).two_pass:
        raise AssertionError(f"[kernels] {shape}: not on the cluster path")

    def chain():
        delta = hn - h - a * (gl - h)
        m = kern._quantize_with_plan(delta, u, levels, two) * scale
        return m, hn, gl + m
    two_arm = (lambda: kern._quantize_with_plan(x, u, levels, two),
               TWO_PASS_NAMES)
    quant = _turns(torch, two_arm,
                   (lambda: kern.quantize(x, u, levels), ["quantize_cluster"]))
    fused = _turns(
        torch, (chain, ["elementwise_kernel"] + TWO_PASS_NAMES),
        (lambda: kern.dasha_quantize_update(hn, h, gl, u, a, scale, levels),
         ["dasha_quantize_cluster"]))
    out = {"shape": list(shape), "quantize_cluster_vs_two_pass": quant,
           "fused_vs_unfused_chain": fused}
    _gate_speedup(f"{shape} cluster vs two-pass", quant)
    _turn_ratio(f"{shape} fused vs the unfused chain", fused)
    if plant:
        planted = _turns(torch, two_arm, two_arm)
        try:
            _gate_speedup(f"{shape} planted: two-pass as the new arm",
                          planted)
        except AssertionError as e:
            log(f"[kernels] planted fault caught: {e}")
        else:
            raise AssertionError(f"[kernels] {shape}: the speedup gate "
                                 f"passed the two-pass path as the new arm "
                                 f"({planted})")
        out["planted_two_pass_as_new"] = planted
    return out


def phase_kernel2(torch):
    """Kernel 2 at every plan path and at the main paths' shapes, the fused
    QDither entry, the turns against the designs they replace, and the
    device floor of one launch."""
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    one = torch.zeros(1, device="cuda")
    floor = kernel_device_ms(torch, lambda: one.add_(1.0),
                             ["elementwise_kernel"])
    log(f"[kernels] launch floor (a one-element torch add, device time): "
        f"{floor} ms")
    rows = []
    for i, (shape, misalign, force) in enumerate(QUANT_CASES):
        r = _check_quantize(torch, kern, ref, shape, misalign, 100 + i,
                            force=force)
        r = {"shape": list(shape), "misaligned": misalign, **r}
        rows.append(r)
        torch.cuda.empty_cache()
        p = r["plan"]
        path = "two-pass" if p["two_pass"] else \
            f"cluster {p['blocks_per_row']} vpt {p['vpt']}"
        log(f"[kernels] quantize {shape}{' misaligned' if misalign else ''} "
            f"{force + ' ' if force else ''}"
            f"{path} vec {p['vec']}: err {r['max_abs_err']:.3g} flips "
            f"{r['one_level_flips']}  call {r['ms']:.4f} ms  device "
            f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.5f} ms")
    fused = []
    for i, (shape, lanes, coins, force) in enumerate(FUSED_CASES):
        r = _check_fused_quantize(torch, kern, ref, shape, lanes, coins,
                                  140 + i, force=force)
        r = {"shape": list(shape), **r}
        fused.append(r)
        torch.cuda.empty_cache()
        p = r["plan"]
        path = "two-pass" if p["two_pass"] else \
            f"cluster {p['blocks_per_row']} vpt {p['vpt']} vec {p['vec']}"
        log(f"[kernels] dasha_quantize_update {shape} lanes {lanes} coins "
            f"{coins} {force + ' ' if force else ''}{path}: err "
            f"{r['max_abs_err']:.3g} flips {r['one_level_flips']}  call "
            f"{r['ms']:.4f} ms  device {r['device_ms']} ms  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms")
    for entry, got in (("quantize", rows), ("dasha_quantize_update", fused)):
        ran = {(r["plan"]["vec"], r["plan"]["vpt"]) for r in got
               if not r["plan"]["two_pass"]}
        if not QUANT_MUST_RUN[entry] <= ran:
            raise AssertionError(f"[kernels] {entry}: cluster kernels (vec, "
                                 f"vpt) {sorted(QUANT_MUST_RUN[entry] - ran)}"
                                 " not run")
    turns = [_quantize_turns(torch, kern, shape, 160 + i, plant=i == 0)
             for i, shape in enumerate(TURN_SHAPES)]
    return {"launch_floor_ms": floor, "quantize": rows, "fused": fused,
            "turns": turns}


SPARSIFY_NAMES = ["dasha_sparsify_rows"]
# the chain the sparsifier entry replaced: indices_to_masks's clamp, fill,
# scatter and slice copy, the coins' mask * scale, the dense-mask entry
CHAIN_NAMES = ["elementwise_kernel", "dasha_update_"]


def _sparsify_inputs(torch, shape, support, scale_kind, misalign, seed):
    """(grad, h, gl, indices, mask, scale) of a sparsifier case on the
    card: RandK rows of K_RANDK indices (one row for shared_coords, the
    plan's 5 rows for 8 lanes), the PermK partition (2 PAD slots at n = 5,
    d = 20,958), a Bernoulli(0.3) mask, or none; the scale d/K, d/K * n/C
    (the cohort's n = 100,000, C = 64), n, 1/p, or coins (2 with a zero
    node) times d/K."""
    from repro_torch.compress.plan import perm_partition
    rows, d = shape
    grad, h, gl, bern, _ = _inputs(torch, shape, seed, misalign)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)

    def randk(k_rows):
        u = torch.rand((k_rows, d), generator=g, device="cuda")
        return torch.topk(u, K_RANDK, dim=1).indices
    indices = mask = None
    if support == "randk":
        indices = randk(rows)
    elif support == "randk_lanes":
        indices = randk(N_NODES)
    elif support == "randk_shared":
        indices = randk(1)
    elif support == "permk":
        indices = perm_partition(torch.Generator().manual_seed(seed), d,
                                 rows, device="cuda")
    elif support == "mask_f32":
        mask = bern
    elif support == "mask_bool_shared":
        mask = (bern[:1] != 0).contiguous()
    dk = d / K_RANDK
    scale = {"d/K": dk, "cohort": dk * (100000 / 64), "n": float(rows),
             "1/p": 1 / 0.3}.get(scale_kind)
    if scale_kind == "coins":
        scale = _coin_scale(torch, rows) * (dk if indices is not None
                                            else 1.0)
    return grad, h, gl, indices, mask, scale


def _sparsify_bytes(shape, indices, mask, scale) -> int:
    """What the entry must move: grad, h, g_local read and m, g_new written
    (20 bytes an element; h_new is grad itself), the support and a per-row
    scale read once."""
    numel = math.prod(shape)
    extra = 0
    for t in (indices, mask, scale):
        if hasattr(t, "element_size"):
            extra += t.numel() * t.element_size()
    return 20 * numel + extra


def _check_sparsify(torch, kern, ref, tag, shape, support, scale_kind,
                    misalign, seed):
    """The sparsifier entry against its plain version (the chain) on a
    case of :data:`SPARSIFY_CASES`."""
    grad, h, gl, indices, mask, scale = _sparsify_inputs(
        torch, shape, support, scale_kind, misalign, seed)
    return {"case": tag, "shape": list(shape), "misaligned": misalign,
            **_sparsify_row(torch, kern, ref, tag, grad, h, gl,
                            1.0 / (2.0 * 208.58 + 1.0), scale, indices,
                            mask)}


def _sparsify_row(torch, kern, ref, tag, grad, h, gl, a, scale, indices,
                  mask, cold: bool = False):
    """The sparsifier entry against its plain version (the chain): m and
    g_new bit-equal, h_out is grad, two launches bit-identical; timed
    beside its bound (20 bytes an element and the support).  ``cold`` adds
    the device time with the L2 cache flushed before every launch
    (``device_ms_cold``)."""
    shape = tuple(grad.shape)

    def launch():
        return kern.dasha_sparsify_update(grad, h, gl, a, scale,
                                          indices=indices, mask=mask)
    out, again = launch(), launch()
    plain = ref.dasha_sparsify_update_ref(grad, h, gl, a, scale,
                                          indices=indices, mask=mask)
    torch.cuda.synchronize()
    if out[1] is not grad:
        raise AssertionError(f"dasha_sparsify_update {tag}: h_out is not "
                             "grad")
    err = max(float((o - p).abs().max()) for o, p in zip(out, plain))
    if not all(_bits_equal(torch, o, p) for o, p in zip(out, plain)) or \
            not all(_bits_equal(torch, o, p) for o, p in zip(out, again)):
        raise AssertionError(f"dasha_sparsify_update {tag} {shape}: "
                             f"max_abs_err {err} (must be bit-equal and "
                             "repeatable)")
    del out, again, plain
    numel = math.prod(shape)
    b, by = bound(_sparsify_bytes(shape, indices, mask, scale), 6 * numel)
    args = kern.sparsify_args(grad, indices, mask, scale)
    floats = [grad, h, gl] + ([mask] if args.form == "mask_f32" else [])
    plan = kern._rows_plan(args, floats,
                           mask if args.form == "mask_u8" else None)
    out = {"form": args.form, "s_rows": args.s_rows, "k": args.k,
           "sc_rows": args.sc_rows, "plan": plan._asdict(),
           "max_abs_err": err, "ms": time_ms(torch, launch),
           "plain_ms": time_ms(torch, lambda: ref.dasha_sparsify_update_ref(
               grad, h, gl, a, scale, indices=indices, mask=mask)),
           "device_ms": kernel_device_ms(torch, launch, SPARSIFY_NAMES),
           "bound_ms": b, "bound_by": by}
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

        def launch_cold():
            flush.zero_()
            launch()
        out["device_ms_cold"] = kernel_device_ms(torch, launch_cold,
                                                 SPARSIFY_NAMES)
    return out


def _sparsify_turns(torch, kern, shape, scale_kind, seed, plant=False):
    """At a main path's shape: the chain the entry replaced (the plan's
    indices to a dense fp32 mask, the coins folded in, the dense-mask
    entry) against the entry, by summed device time, gated at
    :data:`SPARSIFY_SPEEDUP_MIN`; with ``plant``, the gate must refuse the
    chain timed as the new arm."""
    from repro_torch.compress.plan import indices_to_masks
    grad, h, gl, indices, _, scale = _sparsify_inputs(
        torch, shape, "randk", scale_kind, False, seed)
    a = 1.0 / (2.0 * 208.58 + 1.0)

    def chain():
        mask = indices_to_masks(indices, shape[1])
        kscale = scale
        if isinstance(scale, torch.Tensor):
            mask = mask * scale
            kscale = 1.0
        return kern.dasha_update(grad, h, gl, mask, a, kscale)
    chain_arm = (chain, CHAIN_NAMES)
    fused_arm = (lambda: kern.dasha_sparsify_update(
        grad, h, gl, a, scale, indices=indices), SPARSIFY_NAMES)
    t = _turns(torch, chain_arm, fused_arm)
    tag = f"{shape} sparsify: the chain vs the entry"
    if _turn_ratio(tag, t) < SPARSIFY_SPEEDUP_MIN:
        raise AssertionError(f"[kernels] {tag}: chain / entry "
                             f"{t['ratio']:.2f} < {SPARSIFY_SPEEDUP_MIN}")
    out = {"shape": list(shape), "scale": scale_kind,
           "chain_vs_entry": t}
    if plant:
        planted = _turns(torch, chain_arm, chain_arm)
        if _turn_ratio(f"{shape} planted: the chain as the new arm",
                       planted) >= SPARSIFY_SPEEDUP_MIN:
            raise AssertionError(f"[kernels] {shape}: the sparsify gate "
                                 f"passed the chain as the new arm "
                                 f"({planted})")
        log("[kernels] planted fault caught: the chain as the new arm "
            f"reads {planted['ratio']:.2f} < {SPARSIFY_SPEEDUP_MIN}")
        out["planted_chain_as_new"] = planted
    return out


def phase_sparsify(torch):
    """Kernel 1's sparsifier entry at every route and the paths' shapes,
    bit-equal to its plain version, and the turns against the chain it
    replaced."""
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    rows = []
    for i, (tag, shape, support, scale_kind, misalign) in \
            enumerate(SPARSIFY_CASES):
        r = _check_sparsify(torch, kern, ref, tag, shape, support,
                            scale_kind, misalign, 200 + i)
        rows.append(r)
        torch.cuda.empty_cache()
        p = r["plan"]
        log(f"[kernels] dasha_sparsify_update {tag} {shape} {r['form']} "
            f"s_rows {r['s_rows']}{' misaligned' if misalign else ''} "
            f"vec {p['vec']} threads "
            f"{p['threads']} grid {p['grid']}: err {r['max_abs_err']:.3g}  "
            f"call {r['ms']:.4f} ms  device {r['device_ms']} ms  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms")
    turns = [_sparsify_turns(torch, kern, shape, kind, 240 + i,
                             plant=i == 0)
             for i, (shape, kind) in enumerate(zip(TURN_SHAPES,
                                                   ("d/K", "coins")))]
    return {"cases": rows, "turns": turns}


def phase_kernels(torch):
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    checks = {"dasha_update": (_check_dasha, SHAPES),
              "dasha_mvr_update": (_check_mvr, MVR_SHAPES)}
    rows = {name: [] for name in checks}
    log("[kernels] library_ms is null for all: no single PyTorch call "
        "computes a fused estimator update, row-wise QSGD with external "
        "uniforms or the SSD intra-chunk block")
    for name, (check, shapes) in checks.items():
        for i, shape in enumerate(shapes):
            misalign = i == len(shapes) - 1
            r = check(torch, kern, ref, shape, misalign, 100 + i)
            r = {"shape": list(shape), "misaligned": misalign, **r}
            rows[name].append(r)
            torch.cuda.empty_cache()
            log(f"[kernels] {name} {shape}"
                f"{' misaligned' if misalign else ''}: err "
                f"{r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  device "
                f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms")
    return rows


def _glm_loss(torch):
    def loss(x, a, y):
        return (1 - 1 / (1 + torch.exp(y * torch.dot(a, x)))) ** 2
    return loss


def phase_main_path(torch):
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method

    n, m, d = N_NODES, M_REALSIM, D_REALSIM
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] real-sim-shaped data ({n}, {m}, {d}) = "
        f"{feats.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    x0 = torch.zeros(d, device="cuda")
    g0 = float(torch.sum(problem.grad_f(x0) ** 2))
    runs = [("dasha", "randk", dict(k=K_RANDK), {}, "dasha_sparsify_update"),
            ("dasha", "qdither", dict(s=S_QDITHER), {}, "quantize"),
            ("page", "randk", dict(k=K_RANDK), dict(B=1, m=m),
             "dasha_sparsify_update")]
    results, launches = [], {name: 0 for name in kern.COUNTS}
    for variant, comp_name, ckw, tkw, kernel in runs:
        comp = make_round_compressor(comp_name, d, n, backend="fused",
                                     device="cuda", **ckw)
        hyper = Hyper.from_theory(variant, comp.omega, n, L=L,
                                  gamma_mult=16, **tkw)
        method = Method.build(variant, comp, FlatSubstrate(problem, n, d),
                              hyper)
        state = method.init(x0, 1, device="cuda")
        driver = Driver(method, metrics={
            "grad_sq": lambda s, _d: torch.sum(problem.grad_f(s.x) ** 2)},
            metric_every=METRIC_EVERY)
        driver.run(state, 3)            # warm-up: cuBLAS, torch.func
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_counts()
        t0 = time.perf_counter()
        state, traces = driver.run(state, ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kern.COUNTS)
        peak = torch.cuda.max_memory_allocated()
        gs = traces["grad_sq"]
        expected_bits = float(d) + ROUNDS * comp.payload_per_node
        tag = f"{variant}/{comp_name}"
        if gs.shape != (ROUNDS,) or not all(math.isfinite(v) for v in gs):
            raise AssertionError(f"{tag}: non-finite or misshapen trace")
        if not gs[-1] < g0:
            raise AssertionError(f"{tag}: ||grad f||^2 {gs[-1]} did not end "
                                 f"below its x0 value {g0}")
        if counts[kernel] != ROUNDS or sum(counts.values()) != ROUNDS:
            raise AssertionError(f"{tag}: launches {counts}, expected "
                                 f"{ROUNDS} of {kernel} only")
        if float(traces["bits_sent"][-1]) != expected_bits:
            raise AssertionError(f"{tag}: bits_sent "
                                 f"{traces['bits_sent'][-1]} != "
                                 f"{expected_bits}")
        for name in launches:
            launches[name] += counts[name]
        # where the time goes: 20 more rounds under the profiler (its CPU
        # tracing slows the host, so the busy share is a lower bound); the
        # QDither round must launch kernel 2's fused entry once a round,
        # no two-pass kernel and no kernel of the plain entry, and the RandK
        # round kernel 1's sparsifier entry once a round, no scatter of a
        # mask build and no dense-mask kernel (a window that lost records
        # is profiled again)
        for attempt in range(1 + PROFILE_RETRIES):
            table, pwall = profiled(torch, lambda: driver.run(state, 20))
            fused = sum(c for k, (c, _) in table.items()
                        if "dasha_quantize_cluster" in k)
            plain = sum(c for k, (c, _) in table.items()
                        if "quantize_cluster" in k
                        and "dasha_quantize_cluster" not in k)
            two_pass = sum(c for k, (c, _) in table.items()
                           if any(nm in k for nm in TWO_PASS_NAMES))
            sparsify = sum(c for k, (c, _) in table.items()
                           if "dasha_sparsify_rows" in k)
            chain = sum(c for k, (c, _) in table.items()
                        if "dasha_update_" in k or "_scatter_gather" in k)
            if kernel == "quantize" and fused == 20 and two_pass == 0 \
                    and plain == 0:
                break
            if kernel == "dasha_sparsify_update" and sparsify == 20 and chain == 0:
                break
            log(f"[main] {variant}/{comp_name}: profiled window {attempt + 1}"
                f" holds {fused} fused, {plain} plain-entry and {two_pass} "
                f"two-pass kernel-2 launches, {sparsify} sparsifier-entry "
                f"and {chain} mask-chain or dense-mask kernel-1 launches")
        else:
            raise AssertionError(f"{variant}/{comp_name}: the fused update "
                                 "not once a round, by its one entry, in "
                                 "the profile")
        busy_s = sum(t for _, t in table.values()) / 1e6
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
        profile = {"rounds": 20, "wall_s": pwall, "device_busy_s": busy_s,
                   "busy_share": busy_s / pwall,
                   "device_ms_per_round": busy_s / 20 * 1e3,
                   "device_launches_per_round":
                       sum(c for c, _ in table.values()) / 20,
                   "quantize_fused_launches": fused,
                   "quantize_plain_entry_launches": plain,
                   "quantize_two_pass_launches": two_pass,
                   "sparsify_launches": sparsify,
                   "mask_chain_launches": chain,
                   "top_kernels": [[k[:90], c, us / 1e3]
                                   for k, (c, us) in top]}
        results.append({"run": tag, "rounds": ROUNDS,
                        "rounds_per_s": ROUNDS / wall, "wall_s": wall,
                        "peak_mem_gb": peak / 1e9, "grad_sq_x0": g0,
                        "grad_sq_final": float(gs[-1]),
                        "bits_sent": float(traces["bits_sent"][-1]),
                        "launches": counts, "gamma": hyper.gamma,
                        "profile": profile})
        log(f"[main] {tag}: {ROUNDS / wall:.1f} rounds/s, peak "
            f"{peak / 1e9:.2f} GB, ||grad f||^2 {g0:.6e} -> {gs[-1]:.6e} "
            f"(rel. drop {(g0 - gs[-1]) / g0:.3e}), bits_sent "
            f"{traces['bits_sent'][-1]}, launches {counts}, device busy "
            f"{profile['busy_share']:.2f} of a profiled 20-round window, "
            f"{profile['device_launches_per_round']:.2f} device launches and "
            f"{profile['device_ms_per_round']:.4f} device ms a round")
        for k, c, ms in profile["top_kernels"]:
            log(f"[main]   {ms:9.3f} ms  x{c:<5d} {k}")
    del feats, labels, problem
    return results, launches


def _draws_to(draws, dev):
    """Injected draws with their tensors moved to ``dev``."""
    plan = draws.plan._replace(**{
        f: getattr(draws.plan, f).to(dev)
        for f in ("scale", "indices", "mask", "dither_u")
        if hasattr(getattr(draws.plan, f), "to")})
    samples = None if draws.samples is None else draws.samples.to(dev)
    return draws._replace(plan=plan, samples=samples)


def phase_agreement(torch):
    """Every variant x backend on the quickstart problem, on the card and
    on the CPU, with the same CPU-drawn randomness (plan, coins, samples)
    injected into both: the ||grad f||^2 traces must agree, bits_sent must
    be equal, and g == mean_i g_i must hold on the card."""
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method

    n, m, d, k, rounds = 5, 64, 60, 10, 30
    theory_kw = {"dasha": {}, "page": dict(B=2, m=m),
                 "mvr": dict(B=4, sigma2=0.1),
                 "sync_mvr": dict(B=4, sigma2=0.1, zeta=float(k), d=d),
                 "marina": dict(zeta=float(k), d=d)}
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    problems = {dev: FiniteSumProblem(_glm_loss(torch), feats.to(dev),
                                      labels.to(dev))
                for dev in ("cpu", "cuda")}
    worst = 0.0
    for variant, tkw in theory_kw.items():
        for backend in ("dense", "sparse", "fused"):
            comps = {dev: make_round_compressor("randk", d, n, k=k,
                                                backend=backend, device=dev)
                     for dev in problems}
            hyper = Hyper.from_theory(variant, comps["cpu"].omega, n, L=L,
                                      gamma_mult=4, **tkw)
            draws = []
            for t in range(rounds):
                rnd = RoundRandom(7, t)
                draws.append(Draws(
                    plan=rnd.plan(comps["cpu"]),
                    page_coin=rnd.coin(hyper.p, "page"),
                    samples=rnd.samples(problems["cpu"], hyper.batch)
                    if hyper.batch > 0 else None,
                    sync_coin=rnd.coin(hyper.p, "sync")))
            traces, finals = {}, {}
            for dev, problem in problems.items():
                method = Method.build(variant, comps[dev],
                                      FlatSubstrate(problem, n, d), hyper)
                state = method.init(torch.zeros(d), 1, device=dev)
                dev_draws = [_draws_to(dr, dev) for dr in draws]

                def step(s, data, method=method, dev_draws=dev_draws):
                    return method.step_full(s, data,
                                            draws=dev_draws[s.t])[0]

                finals[dev], traces[dev] = Driver(step, metrics={
                    "grad_sq": lambda s, _d, p=problem: torch.sum(
                        p.grad_f(s.x) ** 2)}).run(state, rounds)
            card = finals["cuda"]
            rel = float(max(abs(a - b) / abs(b) for a, b in zip(
                traces["cuda"]["grad_sq"], traces["cpu"]["grad_sq"])))
            worst = max(worst, rel)
            tag = f"{variant}/{backend}"
            if rel > 1e-4 or not (traces["cuda"]["bits_sent"]
                                  == traces["cpu"]["bits_sent"]).all():
                raise AssertionError(f"{tag}: card and CPU disagree "
                                     f"(max rel err {rel})")
            if not torch.allclose(card.g, card.g_local.mean(0), rtol=1e-5,
                                  atol=1e-6):
                raise AssertionError(f"{tag}: g != mean_i g_i on the card")
    log(f"[agree] 5 variants x dense/sparse/fused, quickstart problem, "
        f"{rounds} rounds with injected CPU draws: card vs CPU max rel err "
        f"{worst:.3g} (limit 1e-4), bits_sent equal, g == mean_i g_i")
    return worst


def _train_args(extra):
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args([
        "--nodes", str(TRAIN_NODES), "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--server-opt", "adam", *extra])


def phase_trainer(torch):
    """The trainer at full width (depth cut), as ``launch.train.main``
    runs it, with the counters zeroed before and read after."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-780m"),
                              num_layers=TRAIN_LAYERS)
    rounds = TRAIN_WARMUP + TRAIN_ROUNDS
    args = _train_args(["--steps", str(rounds), "--log-every",
                        str(TRAIN_WARMUP), "--variant", "mvr",
                        "--use-kernel"])
    torch.cuda.empty_cache()
    kern.reset_counts()
    res = train(cfg, args, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = dict(kern.COUNTS)
    peak = max(c["peak_mem_gb"] for c in res.chunks) * 1e9
    leaves = len(tree.leaves(res.state.x))
    # memory: the state between rounds, and one node's forward + backward
    # on top of it (the rest of the peak is the round's per-node trees)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = {k: v[0] for k, v in res.driver.data_fn(res.data_seed, 0).items()}
    ps = [p.detach().requires_grad_(True) for p in tree.leaves(res.state.x)]
    paths = [path for path, _ in tree.items(res.state.x)]
    loss = lm.loss_fn(cfg, tree.from_items(zip(paths, ps)), batch)[0]
    torch.autograd.grad(loss, ps)
    torch.cuda.synchronize()
    node_pass = torch.cuda.max_memory_allocated() - resident
    del batch, ps, loss
    if counts["dasha_mvr_update"] != leaves * rounds or \
            counts["dasha_update"] or counts["dasha_sparsify_update"] or \
            counts["quantize"]:
        raise AssertionError(f"trainer launches {counts}, expected "
                             f"{leaves} leaves x {rounds} rounds of "
                             "dasha_mvr_update only")
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses) or \
            not losses[-1] < res.loss0:
        raise AssertionError(f"trainer eval loss {res.loss0} -> {losses}: "
                             "must be finite and end lower")
    timed = res.chunks[1:]                      # the first chunk warms up
    wall = sum(c["seconds"] for c in timed)
    timed_rounds = rounds - TRAIN_WARMUP
    tokens = TRAIN_NODES * TRAIN_BATCH * TRAIN_SEQ
    numel = res.n_params * TRAIN_NODES
    # kernel 3 on the bool draw: 4 reads, 3 writes and a mask byte
    k3_bound = numel * 29 / HBM_BYTES_PER_S * 1e3
    # where the time goes: a few more rounds under the profiler (its CPU
    # tracing slows the host, so the busy share is a lower bound)
    table, pwall = profiled(torch, lambda: res.driver.run(
        res.state, TRAIN_PROFILED, data_seed=res.data_seed))
    busy_s = sum(t for _, t in table.values()) / 1e6
    k3_us = sum(t for k, (_, t) in table.items() if "dasha_mvr_update" in k)
    k3_ms = k3_us / 1e3 / TRAIN_PROFILED
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
    out = {"layers": TRAIN_LAYERS, "d_model": cfg.d_model,
           "vocab_padded": cfg.padded_vocab, "params": res.n_params,
           "leaves": leaves, "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "rounds_timed": timed_rounds,
           "rounds_per_s": timed_rounds / wall,
           "tokens_per_s": timed_rounds * tokens / wall,
           "round_ms": wall / timed_rounds * 1e3,
           "peak_mem_gb": peak / 1e9, "resident_mem_gb": resident / 1e9,
           "node_pass_mem_gb": node_pass / 1e9,
           "eval_loss_start": res.loss0,
           "eval_loss_end": losses[-1], "launches": counts,
           "kernel_device_ms_per_round": k3_ms,
           "kernel_bound_ms_per_round": k3_bound,
           "kernel_share_of_profiled_round": k3_ms / (pwall * 1e3
                                                      / TRAIN_PROFILED),
           "profile": {"rounds": TRAIN_PROFILED, "wall_s": pwall,
                       "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                       "device_launches_per_round":
                           sum(c for c, _ in table.values()) / TRAIN_PROFILED,
                       "top_kernels": [[k[:90], c, us / 1e3]
                                       for k, (c, us) in top]},
           "chunks": res.chunks}
    log(f"[train] mamba2-780m {TRAIN_LAYERS}/48 layers, "
        f"{res.n_params / 1e6:.1f}M params, {leaves} leaves: "
        f"{out['rounds_per_s']:.3f} rounds/s, {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak / 1e9:.2f} GB (state between rounds "
        f"{resident / 1e9:.2f} GB, one node's forward + backward "
        f"{node_pass / 1e9:.2f} GB), eval loss {res.loss0:.4f} -> "
        f"{losses[-1]:.4f}, launches {counts}")
    log(f"[train] dasha_mvr_update {k3_ms:.3f} ms device per round vs a "
        f"{k3_bound:.3f} ms bound, {out['kernel_share_of_profiled_round']:.3f}"
        f" of a profiled round; device busy {out['profile']['busy_share']:.3f}"
        f", {out['profile']['device_launches_per_round']:.1f} device launches "
        "a round (no mask conversion pass: the kernel reads the bool draw)")
    for k, c, ms in out["profile"]["top_kernels"]:
        log(f"[train]   {ms:9.3f} ms  x{c:<5d} {k}")
    del res
    torch.cuda.empty_cache()
    return out, counts


def _states_agree(torch, got, want, limit):
    """Worst leaf error over (x, g, g_local, h_local), as a fraction of
    each leaf's largest magnitude."""
    from repro_torch.core import tree
    worst = 0.0
    for name in ("x", "g", "g_local", "h_local"):
        for path, w in tree.items(getattr(want, name)):
            g = tree.get(getattr(got, name), path).float().cpu()
            w = w.float()
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((g - w).abs().max()) / scale)
    if not worst <= limit:
        raise AssertionError(f"card and CPU states differ by {worst} of a "
                             f"leaf's largest magnitude (limit {limit})")
    return worst


def phase_trainer_agreement(torch):
    """Smoke-size float32 Mamba2 trained on the card and on the CPU with
    the same CPU-drawn masks, sync coins and batches.  SGD server: Adam's
    sign-like first steps would turn gradient rounding noise into
    whole-step differences (see tests/test_torch_train.py)."""
    from repro_torch.compress import treelevel
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches)
    from repro_torch.methods import Driver
    from repro_torch.models import init_params, lm
    from repro_torch.optim.distributed import DashaTrainConfig, make_method

    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              dtype="float32")
    n, rounds, limit = TRAIN_NODES, 3, 5e-4
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batches = [make_node_batches(t, text, n, 2, device="cpu")
               for t in range(rounds)]
    params = init_params(cfg, 0, device="cpu")
    worst = 0.0
    for variant in ("dasha", "mvr", "sync_mvr"):
        for mode in ("independent", "permk"):
            for use_kernel in (False, True):
                dcfg = DashaTrainConfig(
                    gamma=0.05, compression=0.25, mode=mode,
                    variant=variant, b=0.1, p=0.5, n_nodes=n,
                    server_opt="sgd", use_kernel=use_kernel)
                zeros = tree.map_leaves(
                    lambda p: torch.zeros((n,) + tuple(p.shape)), params)
                draws = []
                for t in range(rounds):
                    rnd = RoundRandom(9, t)
                    masks, _ = treelevel.tree_masks(
                        rnd, zeros, mode=mode, p=dcfg.compression, n=n)
                    draws.append(Draws(masks=masks,
                                       sync_coin=rnd.coin(dcfg.p, "sync")))
                finals = {}
                for dev in ("cpu", "cuda"):
                    method = make_method(
                        dcfg, lambda p, b: lm.loss_fn(cfg, p, b)[0])
                    state = method.init(
                        tree.map_leaves(lambda p: p.to(dev), params), 1,
                        init_mode="zeros", device=dev)
                    dev_draws = [d._replace(masks=tree.map_leaves(
                        lambda m: m.to(dev), d.masks)) for d in draws]

                    def step(s, data, method=method, dev_draws=dev_draws):
                        return method.step_full(s, data,
                                                draws=dev_draws[s.t])[0]

                    def data_fn(seed, t, dev=dev):
                        return {k: v.to(dev) for k, v in batches[t].items()}

                    finals[dev], _ = Driver(step, data_fn=data_fn).run(
                        state, rounds, data_seed=0)
                tag = f"{variant}/{mode}/kernel={use_kernel}"
                try:
                    err = _states_agree(torch, finals["cuda"],
                                        finals["cpu"], limit)
                except AssertionError as e:
                    raise AssertionError(f"{tag}: {e}") from None
                worst = max(worst, err)
    log(f"[train-agree] smoke Mamba2 f32, dasha/mvr/sync_mvr x "
        f"independent/permk x kernel off/on, {rounds} rounds with injected "
        f"CPU masks, coins and batches: card vs CPU worst {worst:.3g} of a "
        f"leaf's largest magnitude (limit {limit})")
    return worst


def _ssd_inputs(torch, shape, dtype, seed):
    """x, dt, A, b, c of the mixer's layout on the card: x, b and c are
    views of one (B, S, H*P + 2N) conv output, as the model hands them."""
    B, S, H, P, N, _ = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), device="cuda", generator=g)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), device="cuda", generator=g))
    A = -torch.exp(0.3 * torch.randn((H,), device="cuda", generator=g))
    xbc, dt = xbc.to(dtype), dt.to(dtype)
    x = xbc[..., :H * P].view(B, S, H, P)
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def ssd_bound(shape, itemsize: int):
    """The least time of one intra-chunk pass: its float32 work counting
    only what the inputs need (the lower triangle; c b^T once per (batch,
    chunk), since it does not depend on the head), against its bytes
    (inputs read once, float32 outputs written once)."""
    B, S, H, P, N, Q = shape
    G, nc = B * H, S // Q
    tri = Q * (Q + 1) // 2
    flops = (2 * B * nc * tri * N            # scores c b^T
             + 2 * G * nc * tri * P          # y_diag
             + 2 * G * nc * Q * N * P        # states
             + 2 * G * nc * tri              # exp and the L * scores product
             + 2 * G * S * P)                # x dt and its decay weight
    nbytes = (itemsize * (B * S * H * P + B * S * H + 2 * B * S * N) + 4 * H
              + 4 * G * nc * (Q * P + N * P + 1 + Q))
    return bound(nbytes, flops), flops, nbytes


def ssd_tc_bound(shape, itemsize: int):
    """The least time of the arithmetic the tensor-core kernel runs, passes
    counted, against the same bytes as :func:`ssd_bound`.  bf16 inputs:
    c b^T once per (batch, chunk) and head group (``ssd_chunk.plan``) in
    one bf16 pass; y_diag's lower triangle and the states in 3 bf16 passes
    each (A split in three parts, x exact), at 989 TFLOP/s.  float32
    inputs: all three products in 3 TF32 passes, at 495 TFLOP/s.  Returns
    ((ms, by), flops, peak FLOP/s)."""
    from repro_torch.kernels import ssd_chunk as kern
    B, S, H, P, N, Q = shape
    G, nc = B * H, S // Q
    tri = Q * (Q + 1) // 2
    hg, _ = kern.plan(itemsize, H, Q, N)
    scores = 2 * B * nc * -(-H // hg) * tri * N
    products = 3 * (2 * G * nc * tri * P + 2 * G * nc * Q * N * P)
    if itemsize == 2:
        flops, rate = scores + products, BF16_FLOPS_PER_S
    else:
        flops, rate = 3 * scores + products, TF32_FLOPS_PER_S
    _, _, nbytes = ssd_bound(shape, itemsize)
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return by, flops, rate


def phase_ssd_kernel(torch, smi: str, shapes=SSD_SHAPES, dtypes=None):
    """ssd_chunk against its plain version on the card (phase 7; phase
    21d at zamba2's shape): each of ``shapes`` in each of ``dtypes``
    (bf16 and float32 by default)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk as kern
    sass = sass_mma_count("ssd_chunk")
    log(f"[ssd] tensor-core instructions in the built library: {sass}")
    if sass["hmma"] is not None and sass["hmma"] + sass["hgmma"] == 0:
        raise AssertionError("ssd_chunk: no HMMA/HGMMA in the library")
    rows = []
    for i, shape in enumerate(shapes):
        for dtype in dtypes or (torch.bfloat16, torch.float32):
            torch.cuda.empty_cache()
            x, dt, A, b, c = _ssd_inputs(torch, shape, dtype, 200 + i)
            Q = shape[-1]
            got = kern.ssd_chunk(x, dt, A, b, c, Q)
            again = kern.ssd_chunk(x, dt, A, b, c, Q)

            def plain():
                return ref.ssd_chunk_ref(*ops.chunk_layout(x, dt, A, b, c, Q))

            want = plain()
            torch.cuda.synchronize()
            errs = {}
            for name, gg, ww in zip(("y_diag", "states", "decays", "acs"),
                                    got, want):
                scale = float(ww.abs().max())
                err = float((gg - ww).abs().max())
                errs[name] = {"max_abs_err": err, "max_abs_plain": scale}
                if not err <= SSD_LIMIT * scale:
                    raise AssertionError(
                        f"ssd_chunk {shape} {dtype}: {name} max_abs_err "
                        f"{err} > {SSD_LIMIT} x {scale}")
            if not all(torch.equal(a, w) for a, w in zip(got, again)):
                raise AssertionError(f"ssd_chunk {shape} {dtype}: two "
                                     "launches differ")
            del got, again, want
            (b_ms, by), flops, nbytes = ssd_bound(shape, x.element_size())
            (tc_ms, tc_by), tc_flops, tc_rate = ssd_tc_bound(
                shape, x.element_size())
            reps = 5 if shape[1] > 4096 else 20
            r = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "errors": errs,
                 "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                 "ms": time_ms(torch, lambda: kern.ssd_chunk(
                     x, dt, A, b, c, Q), reps=reps),
                 "plain_ms": time_ms(torch, plain, reps=reps),
                 "device_ms": kernel_device_ms(torch, lambda: kern.ssd_chunk(
                     x, dt, A, b, c, Q), ["ssd_chunk_kernel"], reps=reps),
                 "bound_ms": b_ms, "bound_by": by, "flops": flops,
                 "bytes": nbytes, "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
                 "tc_flops": tc_flops, "tc_peak_flops_per_s": tc_rate,
                 "head_group": kern.plan(x.element_size(), shape[2],
                                         Q, shape[4])[0], "sass_mma": sass}
            rows.append(r)
            log(f"[ssd] {shape} {r['dtype']}: err {r['max_abs_err']:.3g} "
                f"(y_diag {errs['y_diag']['max_abs_err']:.3g} of "
                f"{errs['y_diag']['max_abs_plain']:.3g})  call "
                f"{r['ms']:.4f} ms  device {r['device_ms']} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({by}, float32)"
                f"  tensor-core bound {tc_ms:.4f} ms ({tc_by})  [{smi}]")
            del x, dt, A, b, c
    torch.cuda.empty_cache()
    return rows


def phase_serve(torch, smi: str):
    """Mamba2-780M at full width and depth through the port's serving entry
    points (phase 8), each part with the launch count zeroed before it and
    read after it."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.kernels import ssd_chunk as kern
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = get_config("mamba2-780m")
    L = cfg.num_layers
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    out = {"layers": L, "params": n_params, "card": smi}

    # (a) prefill: the last position's logits of 4 x 32,768 tokens
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size,
                               seq_len=PREFILL_SEQ)
    tokens = make_lm_batch(1, text, PREFILL_BATCH, device="cuda")["tokens"]
    kern.reset_counts()
    logits = S.prefill_logits(cfg, params, tokens)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PREFILL_TIMED):
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    calls = 1 + PREFILL_TIMED
    launches = kern.COUNTS["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    if launches != L * calls:
        raise AssertionError(f"prefill: ssd_chunk launches {launches}, "
                             f"expected {L} layers x {calls} calls")
    if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             "misshapen or not finite")
    table, pwall = profiled(torch, lambda: S.prefill_logits(cfg, params,
                                                            tokens))
    busy_s = sum(t for _, t in table.values()) / 1e6
    k_count = sum(c for k, (c, _) in table.items() if "ssd_chunk_kernel" in k)
    k_ms = sum(t for k, (_, t) in table.items()
               if "ssd_chunk_kernel" in k) / 1e3
    if k_count != L:
        # a window that missed launches measures nothing
        log(f"[serve] the profiled prefill call recorded {k_count} "
            f"ssd_chunk launches, not {L}: no device time for it")
        k_ms = None
    layer = (PREFILL_BATCH, PREFILL_SEQ, cfg.ssm_nheads, cfg.ssm_headdim,
             cfg.ssm_state, cfg.ssd_chunk)
    (b_ms, by), _, _ = ssd_bound(layer, 2)
    (tc_ms, tc_by), _, _ = ssd_tc_bound(layer, 2)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
    wall = sum(walls) / len(walls)
    ntok = PREFILL_BATCH * PREFILL_SEQ
    out["prefill"] = {
        "batch": PREFILL_BATCH, "seq": PREFILL_SEQ, "walls_s": walls,
        "tokens_per_s": ntok / wall, "peak_mem_gb": peak / 1e9,
        "ssd_chunk_launches": launches,
        "ssd_chunk_profiled_launches": k_count,
        "ssd_chunk_device_ms_per_layer": None if k_ms is None else k_ms / L,
        "ssd_chunk_bound_ms_per_layer": b_ms, "bound_by": by,
        "ssd_chunk_tc_bound_ms_per_layer": tc_ms, "tc_bound_by": tc_by,
        "ssd_chunk_share_of_call": None if k_ms is None
        else k_ms / (pwall * 1e3),
        "profile": {"wall_s": pwall, "device_busy_s": busy_s,
                    "busy_share": busy_s / pwall,
                    "top_kernels": [[k[:90], c, us / 1e3]
                                    for k, (c, us) in top]}}
    log(f"[serve] mamba2-780m {L}/48 layers, {n_params / 1e6:.1f}M params, "
        f"bf16 ({smi}): prefill {PREFILL_BATCH}x{PREFILL_SEQ} in "
        f"{walls} s, {ntok / wall:.0f} tokens/s, peak {peak / 1e9:.2f} GB, "
        f"ssd_chunk launches {launches}; profiled call {pwall:.3f} s, device "
        f"busy {busy_s / pwall:.3f}, ssd_chunk "
        f"{out['prefill']['ssd_chunk_device_ms_per_layer']} ms a layer vs "
        f"a {b_ms:.3f} ms float32 bound ({by}) and a {tc_ms:.3f} ms "
        f"tensor-core bound ({tc_by}), "
        f"{out['prefill']['ssd_chunk_share_of_call']} of the call")
    for k, c, ms in out["prefill"]["profile"]["top_kernels"]:
        log(f"[serve]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens
    torch.cuda.empty_cache()

    # (b) serve: a 32-token prompt stepped through decode_step, 32 new
    # (the recurrence: no ssd_chunk launch)
    args = S.build_parser().parse_args([
        "--batch", str(DECODE_BATCH), "--prompt-len", str(DECODE_PROMPT),
        "--new-tokens", str(DECODE_NEW)])
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    launches_b = kern.COUNTS["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    if res.tokens.shape != (DECODE_BATCH, DECODE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"serve tokens {res.tokens.shape} misshapen "
                             "or out of the vocabulary")
    cache_gb = sum(t.numel() * t.element_size()
                   for t in res.state.cache.values()) / 1e9
    # not a gate: the bf16 kernel prefill of the same prompt against the
    # last prompt step (tests/test_torch_serve.py holds this gap to the
    # reference's own)
    gap, agree = _logit_gap(S, cfg, S.prefill_logits(
        cfg, params, res.prompt)[:, 0], res.last_logits)
    out["decode"] = {
        "batch": DECODE_BATCH, "prompt": DECODE_PROMPT, "new": DECODE_NEW,
        "decode_s": res.decode_s,
        "decode_tokens_per_s": DECODE_BATCH * DECODE_NEW / res.decode_s,
        "ms_per_step": res.decode_s / DECODE_NEW * 1e3,
        "prompt_steps_s": res.prefill_s,
        "prompt_ms_per_step": res.prefill_s / DECODE_PROMPT * 1e3,
        "cache_gb": cache_gb,
        "peak_mem_gb": peak / 1e9, "ssd_chunk_launches": launches_b,
        "bf16_prefill_vs_step_err": gap, "bf16_first_token_agree": agree,
        "first_row": res.tokens[0].tolist()}
    log(f"[serve] bf16 kernel prefill of the {DECODE_BATCH} x "
        f"{DECODE_PROMPT} prompt vs its last decode step (not a gate): "
        f"{gap:.3e} of max |logit|, greedy tokens agree on {agree:.3f} of "
        "rows")
    # where a decode step's time goes: a few more steps under the profiler
    # (its CPU tracing slows the host, so the busy share is a lower bound)
    from repro_torch.models import lm
    state = res.state

    def steps():
        with torch.inference_mode():
            tok = state.tok
            for i in range(DECODE_PROFILED):
                logits, _ = lm.decode_step(S.kernel_config(cfg), params,
                                           state.cache, tok, state.t + i)
                tok = S.greedy(cfg, logits)

    table, pwall = profiled(torch, steps)
    busy_s = sum(t for _, t in table.values()) / 1e6
    n_kernels = sum(c for c, _ in table.values())
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    out["decode_profile"] = {
        "steps": DECODE_PROFILED, "wall_s": pwall, "device_busy_s": busy_s,
        "busy_share": busy_s / pwall,
        "device_ms_per_step": busy_s / DECODE_PROFILED * 1e3,
        "kernels_per_step": n_kernels / DECODE_PROFILED,
        "top_kernels": [[k[:90], c, us / 1e3] for k, (c, us) in top]}
    log(f"[serve] decode profile ({smi}), {DECODE_PROFILED} steps: "
        f"{pwall / DECODE_PROFILED * 1e3:.2f} ms a step under the profiler, "
        f"device busy {busy_s / pwall:.3f} "
        f"({busy_s / DECODE_PROFILED * 1e3:.2f} ms of device work a step), "
        f"{n_kernels / DECODE_PROFILED:.0f} kernels a step")
    for k, c, ms in out["decode_profile"]["top_kernels"]:
        log(f"[serve]   {ms:9.3f} ms  x{c:<5d} {k}")
    log(f"[serve] decode batch {DECODE_BATCH} ({smi}): {DECODE_NEW} steps in "
        f"{res.decode_s:.3f} s, {out['decode']['ms_per_step']:.2f} ms a step, "
        f"{out['decode']['decode_tokens_per_s']:.0f} tokens/s; prompt "
        f"{out['decode']['prompt_ms_per_step']:.2f} ms a step; cache "
        f"{cache_gb:.2f} GB, peak {peak / 1e9:.2f} GB; first row "
        f"{res.tokens[0][:16].tolist()}")
    del res, params, state
    torch.cuda.empty_cache()

    # (c) kernel prefill vs decode recurrence at full width, float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, 0, device="cuda")
    args = S.build_parser().parse_args([
        "--batch", str(PARITY_BATCH), "--prompt-len", str(PARITY_PROMPT),
        "--new-tokens", "4"])
    res = S.serve(cfg32, args, device="cuda", params=params, log=log)
    kern.reset_counts()
    first = S.prefill_logits(cfg32, params, res.prompt)[:, 0]
    torch.cuda.synchronize()
    if kern.COUNTS["ssd_chunk"] != L:
        raise AssertionError(f"parity: ssd_chunk launches "
                             f"{kern.COUNTS['ssd_chunk']}, expected {L}")
    err, agree = _logit_gap(S, cfg32, first, res.last_logits)
    if not err <= PARITY_LIMIT:
        raise AssertionError(f"kernel prefill vs decode recurrence: "
                             f"{err} of max |logit| > {PARITY_LIMIT}")
    out["parity_f32"] = {"batch": PARITY_BATCH, "prompt": PARITY_PROMPT,
                         "err_of_max_logit": err, "limit": PARITY_LIMIT,
                         "greedy_agree": agree,
                         "max_logit": float(res.last_logits.abs().max())}
    log(f"[serve] float32 full width ({smi}), {PARITY_BATCH} x "
        f"{PARITY_PROMPT}: kernel prefill vs the {PARITY_PROMPT}th decode "
        f"step {err:.3e} of max |logit| (limit {PARITY_LIMIT}), greedy "
        f"tokens agree on {agree:.3f} of rows")
    del res, params, first
    torch.cuda.empty_cache()
    return out, launches


def _logit_gap(S, cfg, got, want):
    """The largest |got - want| as a fraction of max |want|, and the share
    of rows whose greedy tokens agree."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max()) / scale
    agree = float((S.greedy(cfg, got) == S.greedy(cfg, want)).float().mean())
    return err, agree


def phase_serve_agreement(torch):
    """The smoke Mamba2 in float32 prefilled and served on the card and on
    the CPU with the same params and prompt (phase 9)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.kernels import ssd_chunk as kern
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              dtype="float32")
    args = S.build_parser().parse_args(["--batch", "4", "--prompt-len", "64",
                                        "--new-tokens", "16"])
    params = init_params(cfg, 0, device="cpu")
    prompt = torch.randint(1, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(5))
    res, first = {}, {}
    for dev in ("cuda", "cpu"):
        dev_params = tree.map_leaves(lambda p, d=dev: p.to(d), params)
        res[dev] = S.serve(cfg, args, device=dev, params=dev_params,
                           prompt=prompt, log=lambda _: None)
        kern.reset_counts()
        first[dev] = S.prefill_logits(cfg, dev_params,
                                      prompt.to(dev))[:, 0].cpu()
        if kern.COUNTS["ssd_chunk"] != (cfg.num_layers if dev == "cuda"
                                        else 0):
            raise AssertionError(f"smoke prefill on {dev}: ssd_chunk "
                                 f"launches {kern.COUNTS['ssd_chunk']}")
    worst = 0.0
    for card, cpu in ((first["cuda"], first["cpu"]),
                      (res["cuda"].last_logits.cpu(),
                       res["cpu"].last_logits)):
        worst = max(worst, float((card - cpu).abs().max())
                    / float(cpu.abs().max()))
    if not worst <= 1e-4:
        raise AssertionError(f"smoke serve: card and CPU logits differ by "
                             f"{worst} of the largest magnitude")
    if not (res["cuda"].tokens == res["cpu"].tokens).all():
        raise AssertionError("smoke serve: card and CPU tokens differ")
    log(f"[serve-agree] smoke Mamba2 f32, 4 x 64 prompt + 16 tokens: card "
        f"vs CPU prefill (kernel vs plain) and last-step logits {worst:.3g} "
        "of the largest magnitude (limit 1e-4), greedy tokens equal")
    return worst


# ---------------------------------------------------------------------------
# the federated slice: kernel 4, the cross-device campaign, agreement
# ---------------------------------------------------------------------------

def _slab_inputs(torch, n, d, idx, seed, offset=0):
    """A random (n, d) store (a view ``offset`` columns into a wider
    buffer when offset > 0) and a random (len(idx), d) slab on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    buf = torch.randn((n, d + 2 * offset), device="cuda", generator=g)
    rows = torch.randn((len(idx), d), device="cuda", generator=g)
    idx_t = torch.as_tensor(idx, dtype=torch.int32, device="cuda")
    return buf, buf[:, offset:offset + d], idx_t, rows


def _slab_shapes():
    """Phase 10's (label, n, d, idx, offset) cases; the cell's ids are a
    real chunk's: the union of 128 rounds of 64-of-100,000 cohorts, with
    its realized sentinel tail."""
    import numpy as np
    from repro_torch.core.rng import cohort_schedule
    from repro_torch.methods.substrates import slab_layout
    n, d = FED_N, D_REALSIM
    cell, _ = slab_layout(cohort_schedule(0, 0, FED_CHUNK, n, FED_C), n)
    big = FED_BIG_N
    ragged = np.concatenate([np.sort(np.random.default_rng(3).choice(
        1000, 32, replace=False)), np.full(5, 1000)])
    return [("cell", n, d, cell, 0),
            ("past_2^31", big, d, np.arange(big - 64, big), 0),
            ("ragged_view", 1000, 4099, ragged, 1),
            ("all_sentinel", 1000, d, np.full(64, 1000), 0),
            ("u_equals_n", 1000, d, np.arange(1000), 0)]


def phase_slab_kernel(torch, smi: str):
    """slab_writeback against its plain version on the card (phase 10):
    set and accumulate bit-equal at each shape, timed beside its bound and
    beside one ``index_copy_`` / ``index_add_`` call over the valid
    rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slab_writeback as kern
    torch.cuda.empty_cache()
    rows_out = []
    for i, (label, n, d, idx, offset) in enumerate(_slab_shapes()):
        u = int((idx < n).sum())
        for accumulate in (False, True):
            buf, full, idx_t, rows = _slab_inputs(torch, n, d, idx, 40 + i,
                                                  offset)
            plain_buf = buf.clone()
            plain = plain_buf[:, offset:offset + d]
            kern.slab_writeback(full, idx_t, rows, accumulate=accumulate)
            ref.slab_writeback_ref(plain, idx_t, rows, accumulate=accumulate)
            torch.cuda.synchronize()
            if not torch.equal(buf, plain_buf):
                raise AssertionError(
                    f"slab_writeback {label} accumulate={accumulate}: "
                    "not bit-equal to the plain version")
            del plain_buf, plain
            width = kern.vec_width(full, rows)
            idx_l = idx_t[:u].to(torch.int64)
            valid = rows[:u]
            if accumulate:
                def lib(full=full, idx_l=idx_l, valid=valid):
                    full.index_add_(0, idx_l, valid)
            else:
                def lib(full=full, idx_l=idx_l, valid=valid):
                    full.index_copy_(0, idx_l, valid)

            def call(full=full, idx_t=idx_t, rows=rows, acc=accumulate):
                kern.slab_writeback(full, idx_t, rows, accumulate=acc)

            def plain_call(full=full, idx_t=idx_t, rows=rows,
                           acc=accumulate):
                ref.slab_writeback_ref(full, idx_t, rows, accumulate=acc)

            b, by = bound((3 if accumulate else 2) * 4 * u * d + 4 * len(idx),
                          u * d if accumulate else 0)
            r = {"shape": label, "n": n, "d": d, "U": len(idx),
                 "valid_rows": u, "accumulate": accumulate,
                 "vec_width": width, "max_abs_err": 0.0,
                 "ms": time_ms(torch, call),
                 "device_ms": kernel_device_ms(
                     torch, call, ["slab_writeback_kernel"]) if u else None,
                 "plain_ms": time_ms(torch, plain_call),
                 "library_ms": time_ms(torch, lib),
                 "bound_ms": b, "bound_by": by}
            rows_out.append(r)
            del buf, full, rows, idx_t, idx_l, valid, lib, call, plain_call
            torch.cuda.empty_cache()
            log(f"[slab] {label} (U {len(idx)}, {u} valid, n {n}, d {d}"
                f"{', offset view' if offset else ''}) "
                f"{'accumulate' if accumulate else 'set'}: bit-equal, "
                f"float{width} access; call {r['ms']:.4f} ms  device "
                f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  "
                f"index_{'add' if accumulate else 'copy'}_ "
                f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms"
                f"  | {smi}")
    return rows_out


def _fed_sim(problem, n, d, c, *, variant="dasha", backend="fused",
             device="cuda", store="auto", k=K_RANDK, hyper_kw=None,
             chunk=None, gamma_mult=16, engine="vec", tau=None):
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FedSim, LinkModel, Lognormal, VecFedSim
    from repro_torch.fed.sim import DEFAULT_CHUNK
    from repro_torch.methods import Hyper, SampledFlatSubstrate
    comp = make_round_compressor("randk", d, n, k=k, backend=backend,
                                 device=device)
    sub = SampledFlatSubstrate(problem, n, d, c=c)
    omega = sub.with_compressor(comp).effective_omega()
    hyper = Hyper.from_theory(variant, omega, n, gamma_mult=gamma_mult,
                              **(hyper_kw or {}))
    uplink = LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                       straggler=Lognormal(1.0))
    cls = FedSim if engine == "heap" else VecFedSim
    return cls(variant, comp, sub, hyper, uplink=uplink, seed=0,
               store=store, chunk=chunk or DEFAULT_CHUNK, tau=tau)


def phase_fed_main(torch, smi: str):
    """Cross-device DASHA at fed_scale_bench's largest campaign and
    real-sim's width (phase 11): VecFedSim on SampledFlatSubstrate over
    n = 100,000 clients x m = 1 x d = 20,958, C = 64, RandK K = 100 on the
    fused backend, 1,000 rounds in chunks of 128 on the slab store, after
    a warm-up chunk.  Gates: launches, participants, bytes, untouched and
    written store rows, the caller's state, finite traces."""
    import numpy as np
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.fed.net import campaign_streams

    n, m, d, c, rounds = FED_N, 1, D_REALSIM, FED_C, FED_ROUNDS
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[fed] ({n}, {m}, {d}) client data = {feats.numel() * 4 / 1e9:.2f}"
        f" GB made on the card in {time.perf_counter() - t0:.2f} s")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)
    sim = _fed_sim(problem, n, d, c, hyper_kw=dict(L=L),
                   chunk=FED_CHUNK)
    if not sim.slab:
        raise AssertionError("store='auto' did not take the slab store")
    state = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
    g0 = float(torch.sum(state.g ** 2))            # g^0 = grad f(x^0)

    def metric(s):
        return torch.sum(s.g ** 2)

    sim.run(state, FED_CHUNK, metric_fn=metric)       # warm-up chunk
    torch.cuda.synchronize()
    # the caller's state, kept on the host so that the card's peak memory
    # is the campaign's own
    shared = state.g_local is state.h_local
    before = {f: getattr(state, f).cpu() for f in ("x", "g", "h_local")
              + (() if shared else ("g_local",))}

    # the timed run: nothing but the campaign
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run(state, rounds, metric_fn=metric)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    tr = res.traces
    chunks = -(-rounds // FED_CHUNK)
    want = {"dasha_sparsify_update": rounds, "slab_writeback": 2 * chunks}
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"[fed] launches {counts}, expected {want}")
    if not np.all(tr["participants"] == c):
        raise AssertionError("[fed] a round without 64 participants")
    up = c * (20 + 8 * K_RANDK)
    if not np.all(tr["bytes_up"] == up) or \
            not np.all(tr["bytes_down"] == c * 4 * d):
        raise AssertionError(f"[fed] bytes: up {set(tr['bytes_up'])} != "
                             f"{up} or down {set(tr['bytes_down'])}")
    for k in ("metric", "sim_wall_clock", "bits_sent"):
        if not np.all(np.isfinite(tr[k])) or tr[k].shape != (rounds,):
            raise AssertionError(f"[fed] trace {k} non-finite/misshapen")

    # the gated run, from the same state: it watches every writeback (the
    # union rows it touched, and that each written store row equals its
    # slab row) and must repeat the timed run bit for bit
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    written_ok = []
    exit_orig = sim._slab_exit

    def watched_exit(st, idx, full_h, full_g):
        out = exit_orig(st, idx, full_h, full_g)
        u = int((idx < n).sum())
        rows = idx[:u].to(torch.int64)
        touched[rows] = True
        written_ok.append(
            torch.equal(out.h_local.index_select(0, rows), st.h_local[:u])
            and torch.equal(out.g_local.index_select(0, rows),
                            st.g_local[:u]))
        return out

    sim._slab_exit = watched_exit
    gated = sim.run(state, rounds, metric_fn=metric)
    sim._slab_exit = exit_orig
    if not written_ok or not all(written_ok):
        raise AssertionError("[fed] a written store row differs from its "
                             "slab row")
    for key in tr:
        if not np.array_equal(tr[key], gated.traces[key]):
            raise AssertionError(f"[fed] the gated run's {key} differs")
    for f in ("x", "g", "h_local", "g_local"):
        if not torch.equal(getattr(res.state, f), getattr(gated.state, f)):
            raise AssertionError(f"[fed] the gated run's {f} differs")
    del gated
    for f, t in before.items():
        if not torch.equal(getattr(state, f).cpu(), t):
            raise AssertionError(f"[fed] run wrote the caller's {f}")
    del before
    untouched_rows = 0
    for f in ("h_local", "g_local"):
        final, start = getattr(res.state, f), getattr(state, f)
        for lo in range(0, n, 8192):
            diff = (final[lo:lo + 8192] != start[lo:lo + 8192]).any(1)
            if bool((diff & ~touched[lo:lo + 8192]).any()):
                raise AssertionError(f"[fed] an untouched {f} row changed")
        untouched_rows = int((~touched).sum())
    del state
    torch.cuda.empty_cache()

    # where a chunk's time goes: one more chunk from the final state (the
    # simulator's own copy, so the in-place writeback is allowed)
    t0 = time.perf_counter()
    md, mu = sim._chunk_multipliers(
        campaign_streams(np.random.default_rng(5), FED_CHUNK), 0, FED_CHUNK)
    draw_s = time.perf_counter() - t0              # the host's numpy draws
    table, pwall = profiled(torch, lambda: sim._chunk_slab(
        res.state, FED_CHUNK, md, mu, metric, None))
    busy_s = sum(t for _, t in table.values()) / 1e6
    slab_hits = [(cnt, us) for key, (cnt, us) in table.items()
                 if "slab_writeback_kernel" in key]
    slab_launches = sum(cnt for cnt, _ in slab_hits)
    slab_ms = sum(us for _, us in slab_hits) / 1e3 \
        if slab_launches == 2 else None
    sels = sim.substrate.cohort_schedule(res.state.seed, res.state.t,
                                         FED_CHUNK)
    u = int(np.unique(sels).size)
    slab_bound, _ = bound(2 * 2 * 4 * u * d, 0)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    gf = float(torch.sum(problem.grad_f(res.state.x) ** 2))
    out = {"n": n, "m": m, "d": d, "C": c, "K": K_RANDK,
           "rounds": rounds, "chunk": FED_CHUNK, "store": "slab",
           "rounds_per_s": rounds / wall, "wall_s": wall,
           "peak_mem_gb": peak / 1e9, "grad_sq_x0": g0,
           "grad_sq_final": gf, "gamma": sim.hyper.gamma,
           "effective_omega": sim._bound.effective_omega(),
           "sim_wall_clock_s": res.summary["wall_clock_s"],
           "bytes_up_per_round": up, "launches": counts,
           "untouched_rows": untouched_rows,
           "multipliers_s_per_chunk": draw_s,
           "profiled_chunk": {
               "rounds": FED_CHUNK, "wall_s": pwall,
               "device_busy_s": busy_s, "busy_share": busy_s / pwall,
               "slab_writeback_launches": slab_launches,
               "slab_writeback_device_ms": slab_ms,
               "slab_writeback_bound_ms": slab_bound,
               "union_rows": u,
               "top_kernels": [[k[:90], cnt, us / 1e3]
                               for k, (cnt, us) in top]},
           "nvidia_smi": smi}
    log(f"[fed] dasha, randk K={K_RANDK} fused, n={n} C={c} d={d}: "
        f"{rounds} rounds in {wall:.2f} s = {rounds / wall:.1f} rounds/s, "
        f"peak {peak / 1e9:.2f} GB, ||grad f||^2 {g0:.6e} -> {gf:.6e}, "
        f"simulated wall clock {res.summary['wall_clock_s']:.2f} s, "
        f"launches {counts}, {untouched_rows} rows never touched | {smi}")
    log(f"[fed] a chunk's straggler multipliers (numpy, 2 x {FED_CHUNK} x "
        f"{n} draws): {draw_s * 1e3:.1f} ms on the host")
    log(f"[fed] profiled chunk: {pwall * 1e3:.1f} ms wall, device busy "
        f"{busy_s / pwall:.3f}; slab_writeback {slab_launches} launches, "
        f"{slab_ms} ms device a chunk against {slab_bound:.4f} ms bound "
        f"({u} union rows) | {smi}")
    for k, cnt, ms in out["profiled_chunk"]["top_kernels"]:
        log(f"[fed]   {ms:9.3f} ms  x{cnt:<5d} {k}")
    del res, problem, feats, labels
    torch.cuda.empty_cache()
    return out, counts, _check_dasha_fed(torch, sim, smi)


def _path_support(torch, plan, rows: int, k: int, tag: str):
    """A RandK plan's support as the path hands it to kernel 1's
    sparsifier entry (``backends._support``): indices, no dense mask;
    each of the plan's rows must hold k distinct columns."""
    from repro_torch.compress.backends import _support
    indices, mask = _support(plan)
    if mask is not None or indices is None or indices.shape[1] != k or \
            rows % indices.shape[0] or \
            any(len(set(r.tolist())) != k for r in indices.cpu()):
        raise AssertionError(f"[{tag}] the round's plan is not RandK "
                             "indices")
    return indices


def _check_dasha_fed(torch, sim, smi: str):
    """Kernel 1's sparsifier entry against its plain version at the
    federated path's shape and scale: the (C, d) cohort, a real round's
    RandK indices, the plan scale d/K * n/C (the n/C inflation folded in,
    as the cohort round does) and the campaign's own momentum a."""
    from repro_torch.core.rng import RoundRandom
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    sub = sim._bound
    c, d = int(sub.c), int(sim.comp.spec.d)
    plan = RoundRandom(0, 0).plan(sub.cohort_rc)
    scale = float(plan.scale) * (sub.n / float(c))
    indices = _path_support(torch, plan, c, K_RANDK, "fed")
    grad, h, gl, _, _ = _inputs(torch, (c, d), 160, False)
    r = _sparsify_row(torch, kern, ref, "fed", grad, h, gl, sim.hyper.a,
                      scale, indices, None)
    r = {"case": "fed", "shape": [c, d], "misaligned": False, "path": "fed",
         "a": sim.hyper.a, "scale": scale, **r}
    log(f"[kernels] dasha_sparsify_update ({c}, {d}) at the federated "
        f"scale {scale:.6g}, a {sim.hyper.a:.6g}: err "
        f"{r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  device "
        f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  bound "
        f"{r['bound_ms']:.5f} ms | {smi}")
    return r


def _fed_draws(sim, problem_cpu, variant, hp, rounds, seed):
    """Every round's randomness drawn on the CPU (cohort, the cohort's
    plan, PAGE's coin, samples), for injection into both devices."""
    from repro_torch.core.rng import Draws, RoundRandom
    sub = sim._bound
    out = []
    for t in range(rounds):
        rnd = RoundRandom(seed, t)
        cohort = rnd.cohort(sub.n, sub.c) if sub.samples_clients else None
        rc = sub.cohort_rc if cohort is not None else sub.rc
        clients = cohort if cohort is not None else list(range(sub.n))
        samples = page_coin = None
        if variant == "page":
            page_coin = rnd.coin(hp.p, "page")
            rows = problem_cpu if cohort is None else dataclasses.replace(
                problem_cpu, features=problem_cpu.features[cohort],
                labels=problem_cpu.labels[cohort])
            samples = rnd.samples(rows, hp.batch)
        elif hasattr(problem_cpu, "stoch_grad"):
            samples = rnd.client_samples(problem_cpu, hp.batch, clients)
        out.append(Draws(plan=rnd.plan(rc), page_coin=page_coin,
                         samples=samples, cohort=cohort))
    return out


def phase_fed_agreement(torch):
    """The example's shape on the card and on the CPU with the same
    injected CPU draws (phase 12a): exact byte and participant traces,
    metrics within 1e-4; then slab vs scatter on the card, bit for bit, at
    n = 10,000, C = 64, d = 20,958 over 128 rounds (phase 12b)."""
    import numpy as np
    from repro_torch.core.oracles import FiniteSumProblem, StochasticProblem
    from repro_torch.data.pipeline import (synthetic_classification,
                                           synthetic_quadratic)

    n, m, d, k, rounds, seed = 256, 8, 40, 8, 60, 7
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    glm = {dev: FiniteSumProblem(_glm_loss(torch), feats.to(dev),
                                 labels.to(dev)) for dev in ("cpu", "cuda")}
    A, b = synthetic_quadratic(0, d, device="cpu")

    def stoch(dev):
        Ad, bd = A.to(dev), b.to(dev)

        def loss(x, xi, i):
            return 0.5 * x @ Ad @ x - bd @ x + xi @ x

        def sample(gen, i, batch):
            return 0.3 * torch.randn((batch, d), generator=gen,
                                     device=gen.device)

        return StochasticProblem(loss=loss, sample=sample, n=n, device=dev,
                                 true_grad=lambda x: Ad @ x - bd)

    quad = {dev: stoch(dev) for dev in ("cpu", "cuda")}
    cases = [(v, be, c) for v in ("dasha", "page")
             for be in ("sparse", "fused") for c in (256, 64, 16)] + \
        [("mvr", "sparse", c) for c in (256, 64, 16)]
    hkw = {"dasha": dict(L=L), "page": dict(L=L, B=2, m=m),
           "mvr": dict(L=2.0, B=4, sigma2=0.09 * d)}
    worst = 0.0
    for variant, backend, c in cases:
        probs = quad if variant == "mvr" else glm
        res, draws = {}, None
        for dev in ("cpu", "cuda"):
            # the quadratic's L = 2 leaves no room for the 16x fine-tune
            sim = _fed_sim(probs[dev], n, d, c, variant=variant,
                           backend=backend, device=dev, k=k,
                           hyper_kw=hkw[variant], chunk=16,
                           gamma_mult=1 if variant == "mvr" else 16)
            if draws is None:
                draws = _fed_draws(sim, probs["cpu"], variant,
                                   sim.hyper, rounds, seed)
                # one initial state: a stochastic init draws its samples
                # from the device's own generator
                state0 = sim.init(torch.zeros(d), 1, device="cpu")
            dev_draws = [_draws_to(dr, dev) for dr in draws]
            state = state0._replace(**{
                f: getattr(state0, f).to(dev)
                for f in ("x", "g", "g_local", "h_local")})
            res[dev] = sim.run(state, rounds, draws=lambda t: dev_draws[t])
        tag = f"{variant}/{backend}/C={c}"
        for key in ("bytes_up", "value_bytes", "bytes_down",
                    "participants", "bits_sent"):
            if not np.array_equal(res["cuda"].traces[key],
                                  res["cpu"].traces[key]):
                raise AssertionError(f"[fed-agree] {tag}: {key} differs")
        wall_rel = float(np.max(np.abs(
            res["cuda"].traces["sim_wall_clock"]
            / res["cpu"].traces["sim_wall_clock"] - 1)))
        a, b_ = res["cuda"].traces["metric"], res["cpu"].traces["metric"]
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b_))):
            raise AssertionError(f"[fed-agree] {tag}: non-finite metric")
        rel = float(np.max(np.abs(a - b_) / np.abs(b_)))
        worst = max(worst, rel)
        if not (rel <= 1e-4 and wall_rel <= 1e-6):
            raise AssertionError(f"[fed-agree] {tag}: metric rel err {rel}"
                                 f", wall clock rel err {wall_rel}")
    log(f"[fed-agree] dasha/page x randk sparse/fused and mvr (stochastic)"
        f" x C in (256, 64, 16), n={n} d={d}, {rounds} rounds with "
        f"injected CPU draws: bytes/participants/bits equal, metric max "
        f"rel err {worst:.3g} (limit 1e-4)")

    # slab vs scatter on the card, the port's own draws
    n2, c2, rounds2 = 10000, 64, 128
    feats2, labels2 = synthetic_classification(1, n2, 1, D_REALSIM,
                                               device="cuda")
    prob2 = FiniteSumProblem(_glm_loss(torch), feats2, labels2)
    L2 = float((feats2.norm(dim=-1) ** 2).mean() * 2)
    runs = {}
    for store in ("slab", "scatter"):
        sim = _fed_sim(prob2, n2, D_REALSIM, c2, store=store,
                       hyper_kw=dict(L=L2), chunk=FED_CHUNK)
        state = sim.init(torch.zeros(D_REALSIM, device="cuda"), 3,
                         device="cuda")
        runs[store] = sim.run(state, rounds2,
                              metric_fn=lambda s: torch.sum(s.g ** 2))
        del state
    a, b_ = runs["slab"], runs["scatter"]
    for key in a.traces:
        if not np.array_equal(a.traces[key], b_.traces[key]):
            raise AssertionError(f"[fed-agree] slab vs scatter: {key}")
    for f in ("x", "g", "g_local", "h_local"):
        if not torch.equal(getattr(a.state, f), getattr(b_.state, f)):
            raise AssertionError(f"[fed-agree] slab vs scatter: {f}")
    log(f"[fed-agree] slab == scatter bit for bit on the card: n={n2} "
        f"C={c2} d={D_REALSIM}, {rounds2} rounds (traces and final state)")
    del runs, a, b_, feats2, labels2, prob2
    torch.cuda.empty_cache()
    return worst


def _heap_links(sigma: float):
    from repro_torch.fed import Constant, LinkModel, Lognormal
    strag = Lognormal(sigma) if sigma > 0 else Constant()
    return dict(uplink=LinkModel(latency_s=HEAP_LATENCY,
                                 bandwidth_Bps=HEAP_UP_BPS, straggler=strag),
                downlink=LinkModel(latency_s=HEAP_LATENCY,
                                   bandwidth_Bps=HEAP_DOWN_BPS))


def _watch_heap(sim, rounds: int, gate: bool = True):
    """Instrument one FedSim instance (its attributes, not the class): the
    host seconds spent in the engine's chunks (the device rounds and the
    chunk's one transfer) and in the codec (encoding and billing a round),
    and, with ``gate``, the decode gate on the first and the last chunk:
    every upload passes ``wire.verify`` and ``decode_round`` equals the
    round's dense message rows (the dense sync upload on a coin round) bit
    for bit, but for the sign of a zero: a mask multiply leaves -0.0 at a
    dropped coordinate, which the wire does not carry."""
    import numpy as np
    from repro_torch.fed import wire
    clock = {"engine_s": 0.0, "codec_s": 0.0, "gate_s": 0.0,
             "gated_rounds": 0, "gated_uploads": 0}
    run_chunk, round_wire = sim._run_chunk, sim._round_wire
    last0 = (rounds - 1) // sim.chunk * sim.chunk
    d = int(sim.comp.spec.d)

    def timed_chunk(*args, **kw):
        t0 = time.perf_counter()
        out = run_chunk(*args, **kw)
        clock["engine_s"] += time.perf_counter() - t0
        return out

    def timed_wire(ys, j, t):
        t0 = time.perf_counter()
        out = round_wire(ys, j, t)
        t1 = time.perf_counter()
        clock["codec_s"] += t1 - t0
        if gate and (t < sim.chunk or t >= last0):
            coin, _active, _rb, bufs, (vals, idxs) = out
            for b in bufs:
                if b is not None:
                    wire.verify(b)
            rows = ys["sync"][j] if coin else sim._dense_rows(vals, idxs)
            dec = wire.decode_round(bufs, d)
            nz = rows != 0
            if not (np.array_equal(dec, rows)
                    and dec[nz].tobytes() == rows[nz].tobytes()):
                raise AssertionError(f"[heap] round {t}: the decoded "
                                     "uploads differ from the messages")
            clock["gated_rounds"] += 1
            clock["gated_uploads"] += sum(b is not None for b in bufs)
            clock["gate_s"] += time.perf_counter() - t1
        return out

    sim._run_chunk, sim._round_wire = timed_chunk, timed_wire
    return clock


def _unwatch_heap(sim):
    """Undo :func:`_watch_heap`: its closures hold the sim they are
    attributes of, a reference cycle that kept the heap phase's 6.06 GB of
    features on the card until the next garbage collection."""
    del sim._run_chunk, sim._round_wire


def _host_split(wall: float, clock, rounds: int):
    """Host ms a round: the engine's chunks, the codec, and the rest of
    the host loop (the arrival heap, link times and traces)."""
    rest = wall - clock["engine_s"] - clock["codec_s"] - clock["gate_s"]
    return {"engine_ms_per_round": clock["engine_s"] / rounds * 1e3,
            "codec_ms_per_round": clock["codec_s"] / rounds * 1e3,
            "heap_ms_per_round": rest / rounds * 1e3,
            "decode_gate_s": clock["gate_s"],
            "gated_rounds": clock["gated_rounds"],
            "gated_uploads": clock["gated_uploads"]}


def _heap_campaigns(torch, smi: str):
    """Phase 13a: the heap oracle at the real-sim shape, as fed_bench's
    straggler_curves runs it, on the card: dasha, dasha with Appendix-D
    participation (p' = 0.5) and marina (p = max(zeta/d, 8/200)), each
    with fused RandK K = 100 (kernel 1) at sigma in (0, 1, 2), and dasha
    with fused QDither s = 15 (kernel 2) at sigma = 1.  Gates: decoded
    uploads, exact bytes, bytes equal across sigma, metric traces equal to
    a plain Driver run of the same Method bit for bit, MARINA degrading
    more than DASHA, launches."""
    import numpy as np
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.fed import FedSim
    from repro_torch.methods import Driver, FlatSubstrate, Hyper

    n, m, d, k, rounds = N_NODES, M_REALSIM, D_REALSIM, K_RANDK, HEAP_ROUNDS
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[heap] real-sim-shaped data ({n}, {m}, {d}) = "
        f"{feats.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    sub = FlatSubstrate(problem, n, d)

    def comp(name, **kw):
        return make_round_compressor(name, d, n, backend="fused",
                                     device="cuda", **kw)

    def hyper(variant, rc):
        # benchmarks/common.py theory_hyper: gamma x4, zeta/d for MARINA
        kw = dict(zeta=float(k), d=d) if variant == "marina" else {}
        return Hyper.from_theory(variant, rc.omega, n, L=L, gamma_mult=4.0,
                                 **kw)

    rc, rc_pp = comp("randk", k=k), comp("randk", k=k, p_participate=0.5)
    rc_q = comp("qdither", s=S_QDITHER)
    hp_m = hyper("marina", rc)
    hp_m = dataclasses.replace(hp_m, p=max(hp_m.p, 8.0 / rounds))
    methods = {"dasha": ("dasha", rc, hyper("dasha", rc)),
               "dasha_pp": ("dasha", rc_pp, hyper("dasha", rc_pp)),
               "marina": ("marina", rc, hp_m),
               "dasha_qdither": ("dasha", rc_q, hyper("dasha", rc_q))}
    campaigns = [(name, s) for s in HEAP_SIGMAS
                 for name in ("dasha", "dasha_pp", "marina")] + \
        [("dasha_qdither", 1.0)]

    def metric(s):
        return torch.sum(s.g ** 2)

    def make(name, sigma):
        variant, rc_, hp = methods[name]
        return FedSim(variant, rc_, sub, hp, compute_s=0.0, seed=HEAP_SEED,
                      chunk=FED_CHUNK, **_heap_links(sigma))

    state = make("dasha", 0.0).init(torch.zeros(d, device="cuda"), 1,
                                    device="cuda")
    for name in methods:                           # warm-up, not counted
        make(name, 1.0).run(state, 4, metric_fn=metric)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    runs = {}
    for name, sigma in campaigns:
        sim = make(name, sigma)
        clock = _watch_heap(sim, rounds)
        t0 = time.perf_counter()
        res = sim.run(state, rounds, metric_fn=metric)
        wall = time.perf_counter() - t0
        _unwatch_heap(sim)
        runs[name, sigma] = (res, wall, clock, sim)
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    fused_randk = sum(1 for name, _ in campaigns if name != "dasha_qdither")
    want = {"dasha_sparsify_update": fused_randk * rounds, "quantize": rounds}
    if any(counts[kk] != v for kk, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"[heap] launches {counts}, expected {want}")
    per_randk, per_dense = n * (20 + 8 * k), n * (20 + 4 * d)
    for (name, sigma), (res, _, clock, _) in runs.items():
        tr = res.traces
        sync = tr["sync_round"].astype(bool)
        part = tr["participants"]
        want_up = {"dasha": np.full(rounds, per_randk),
                   "marina": np.where(sync, per_dense, per_randk),
                   "dasha_qdither": np.full(rounds, per_dense),
                   "dasha_pp": part * (20 + 8 * k)}[name]
        tag = f"[heap] {name} sigma={sigma}"
        if not np.array_equal(tr["bytes_up"], want_up):
            raise AssertionError(f"{tag}: bytes up {tr['bytes_up'][:8]} "
                                 f"!= {want_up[:8]}")
        if name == "marina" and not (sync.any() and not sync.all()):
            raise AssertionError(f"{tag}: no sync round or no other")
        if name == "dasha_pp" and not ((part < n).any() and
                                       (part > 0).any()):
            raise AssertionError(f"{tag}: participation never varied")
        if name != "marina" and sync.any():
            raise AssertionError(f"{tag}: a sync round")
        for key in ("metric", "sim_wall_clock", "bits_sent"):
            if not np.all(np.isfinite(tr[key])) or \
                    tr[key].shape != (rounds,):
                raise AssertionError(f"{tag}: trace {key} non-finite or "
                                     "misshapen")
        last0 = (rounds - 1) // FED_CHUNK * FED_CHUNK
        gated = sum(1 for t in range(rounds)
                    if t < FED_CHUNK or t >= last0)
        if clock["gated_rounds"] != gated:
            raise AssertionError(f"{tag}: {clock['gated_rounds']} rounds "
                                 f"went through the decode gate, not "
                                 f"{gated}")
    # common random numbers: the same method's bytes, coins, participants
    # and math at every sigma
    for name in ("dasha", "dasha_pp", "marina"):
        a = runs[name, HEAP_SIGMAS[0]][0].traces
        for sigma in HEAP_SIGMAS[1:]:
            b = runs[name, sigma][0].traces
            for key in ("bytes_up", "participants", "sync_round", "metric",
                        "bits_sent"):
                if not np.array_equal(a[key], b[key]):
                    raise AssertionError(f"[heap] {name}: {key} differs "
                                         f"between sigma 0 and {sigma}")
    # the simulator's math is the engine's: a plain Driver run of the same
    # Method gives the same metric trace and bits, bit for bit
    for name in methods:
        sigma = 1.0 if name == "dasha_qdither" else HEAP_SIGMAS[0]
        res, _, _, sim = runs[name, sigma]
        _, tr = Driver(sim.method, metrics={
            "metric": lambda s, _d: metric(s)}).run(state, rounds)
        if not (np.array_equal(res.traces["metric"],
                               tr["metric"].astype(np.float64))
                and np.array_equal(res.traces["bits_sent"],
                                   tr["bits_sent"].astype(np.float64))):
            raise AssertionError(f"[heap] {name}: the metric or bits trace "
                                 "differs from the Driver's")
    wall_clock = {name: [float(runs[name, s][0].summary["wall_clock_s"])
                         for s in HEAP_SIGMAS]
                  for name in ("dasha", "dasha_pp", "marina")}
    degradation = {name: [w - c[0] for w in c]
                   for name, c in wall_clock.items()}
    gaps = [mw - dw for mw, dw in zip(wall_clock["marina"],
                                      wall_clock["dasha"])]
    no_sync_ok = all(degradation["marina"][i] > degradation["dasha"][i]
                     for i in range(1, len(HEAP_SIGMAS)))
    if not no_sync_ok:
        raise AssertionError(f"[heap] MARINA's wall clock degraded no more "
                             f"than DASHA's: {degradation}")

    # where a chunk's time goes: one more dasha chunk at sigma = 1
    sim = make("dasha", 1.0)
    table, pwall = profiled(torch, lambda: sim.run(state, FED_CHUNK,
                                                   metric_fn=metric))
    busy_s = sum(t for _, t in table.values()) / 1e6
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"n": n, "m": m, "d": d, "K": k, "s_qdither": S_QDITHER,
           "rounds": rounds, "chunk": FED_CHUNK, "sigmas": list(HEAP_SIGMAS),
           "links": {"up_Bps": HEAP_UP_BPS, "down_Bps": HEAP_DOWN_BPS,
                     "latency_s": HEAP_LATENCY, "compute_s": 0.0,
                     "seed": HEAP_SEED},
           "marina_p": hp_m.p, "launches": counts, "peak_mem_gb": peak / 1e9,
           "wall_clock_s": wall_clock, "degradation_s": degradation,
           "marina_minus_dasha_s": gaps, "no_sync_advantage_ok": no_sync_ok,
           "gaps_widen": all(gaps[i] > gaps[i - 1]
                             for i in range(1, len(gaps))),
           "campaigns": [], "nvidia_smi": smi,
           "profiled_chunk": {
               "campaign": "dasha sigma=1", "rounds": FED_CHUNK,
               "wall_s": pwall, "device_busy_s": busy_s,
               "busy_share": busy_s / pwall,
               "top_kernels": [[kk[:90], cnt, us / 1e3]
                               for kk, (cnt, us) in top]}}
    for (name, sigma), (res, wall, clock, _) in runs.items():
        tr = res.traces
        row = {"campaign": name, "sigma": sigma, "wall_s": wall,
               "rounds_per_s": rounds / wall,
               "rounds_per_s_without_gate":
                   rounds / (wall - clock["gate_s"]),
               **_host_split(wall, clock, rounds),
               "sim_wall_clock_s": float(res.summary["wall_clock_s"]),
               "bytes_up": res.summary["bytes_up"],
               "sync_rounds": res.summary["sync_rounds"],
               "mean_participants": res.summary["mean_participants"],
               "metric_first": float(tr["metric"][0]),
               "metric_last": float(tr["metric"][-1])}
        out["campaigns"].append(row)
        log(f"[heap] {name} sigma={sigma:g}: {rounds} rounds in {wall:.3f} s"
            f" = {row['rounds_per_s']:.1f} rounds/s "
            f"({row['rounds_per_s_without_gate']:.1f} without the decode "
            f"gate); host ms a round: engine "
            f"{row['engine_ms_per_round']:.3f}, codec "
            f"{row['codec_ms_per_round']:.3f}, heap and loop "
            f"{row['heap_ms_per_round']:.3f}; simulated "
            f"{row['sim_wall_clock_s']:.3f} s, {int(row['sync_rounds'])} "
            f"sync rounds, {row['bytes_up']:.0f} bytes up, "
            f"{clock['gated_uploads']} uploads decoded | {smi}")
    log(f"[heap] wall clock by sigma {list(HEAP_SIGMAS)}: {wall_clock}; "
        f"MARINA - DASHA {gaps}; no-sync advantage "
        f"{no_sync_ok}; launches {counts}; peak {peak / 1e9:.2f} GB")
    log(f"[heap] profiled dasha chunk: {pwall * 1e3:.1f} ms wall, device "
        f"busy {busy_s / pwall:.3f} | {smi}")
    for kk, cnt, ms in out["profiled_chunk"]["top_kernels"]:
        log(f"[heap]   {ms:9.3f} ms  x{cnt:<5d} {kk}")
    del runs, sim, state, problem, sub, feats, labels
    torch.cuda.empty_cache()
    return out, counts


def _heap_sampled(torch, smi: str):
    """Phase 13b: the sampled heap campaign on the slab store at phase
    12b's shape (n = 10,000 x m = 1 x d = 20,958, C = 64, sparse RandK
    K = 100, phase 11's uplink, 256 rounds in chunks of 128), against
    VecFedSim on the same seed and links."""
    import numpy as np
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification

    n, c, d, rounds = HEAP_N, FED_C, D_REALSIM, HEAP_SAMPLED_ROUNDS
    feats, labels = synthetic_classification(1, n, 1, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)
    kw = dict(backend="sparse", k=K_RANDK, hyper_kw=dict(L=L),
              chunk=FED_CHUNK)
    heap = _fed_sim(problem, n, d, c, engine="heap", **kw)
    vec = _fed_sim(problem, n, d, c, **kw)
    if not heap.slab:
        raise AssertionError("[heap] store='auto' did not take the slab "
                             "store")
    state = heap.init(torch.zeros(d, device="cuda"), 3, device="cuda")

    def metric(s):
        return torch.sum(s.g ** 2)

    heap.run(state, 4, metric_fn=metric)              # warm-up
    torch.cuda.synchronize()
    _reset_launch_counts()
    clock = _watch_heap(heap, rounds, gate=False)
    t0 = time.perf_counter()
    rh = heap.run(state, rounds, metric_fn=metric, log_events=True)
    wall = time.perf_counter() - t0
    _unwatch_heap(heap)
    counts = _launch_counts()
    chunks = -(-rounds // FED_CHUNK)
    if counts["slab_writeback"] != 2 * chunks or \
            sum(counts.values()) != 2 * chunks:
        raise AssertionError(f"[heap] sampled launches {counts}, expected "
                             f"{2 * chunks} slab writebacks only")
    tr = rh.traces
    up, down = c * (20 + 8 * K_RANDK), c * 4 * d
    if not (np.all(tr["participants"] == c) and np.all(tr["bytes_up"] == up)
            and np.all(tr["bytes_down"] == down)):
        raise AssertionError(f"[heap] sampled: participants "
                             f"{set(tr['participants'])}, bytes up "
                             f"{set(tr['bytes_up'])} != {up}, down "
                             f"{set(tr['bytes_down'])} != {down}")
    applied = sum(e.kind == "apply" for e in rh.events)
    if applied != c * rounds:
        raise AssertionError(f"[heap] sampled: {applied} uploads applied")
    t0 = time.perf_counter()
    rv = vec.run(state, rounds, metric_fn=metric)
    vec_wall = time.perf_counter() - t0
    for key in ("bytes_up", "value_bytes", "bytes_down", "participants",
                "sync_round"):
        if not np.array_equal(rh.traces[key], rv.traces[key]):
            raise AssertionError(f"[heap] heap vs vec: {key} differs")
    # tests/test_fed_scale.py::_assert_equivalent's tolerances
    limits = {"sim_wall_clock": (2e-6, 0.0), "bits_sent": (1e-6, 0.0),
              "metric": (1e-4, 1e-9)}
    errs = {}
    for key, (rtol, atol) in limits.items():
        a, b = rv.traces[key], rh.traces[key]
        errs[key] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                            1e-30)))
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"[heap] heap vs vec: {key} rel err "
                                 f"{errs[key]} (rtol {rtol})")
    for key in ("bytes_up", "bytes_down", "sync_rounds",
                "mean_participants"):
        if rh.summary[key] != rv.summary[key]:
            raise AssertionError(f"[heap] heap vs vec: summary {key}")
    out = {"n": n, "C": c, "d": d, "K": K_RANDK, "rounds": rounds,
           "chunk": FED_CHUNK, "store": "slab", "backend": "sparse",
           "wall_s": wall, "rounds_per_s": rounds / wall,
           **_host_split(wall, clock, rounds),
           "vec_wall_s": vec_wall, "vec_rounds_per_s": rounds / vec_wall,
           "sim_wall_clock_s": float(rh.summary["wall_clock_s"]),
           "bytes_up_per_round": up, "bytes_down_per_round": down,
           "launches": counts, "heap_vs_vec_rel_err": errs,
           "nvidia_smi": smi}
    log(f"[heap] sampled dasha, sparse RandK K={K_RANDK}, n={n} C={c} "
        f"d={d}, slab store: {rounds} rounds in {wall:.3f} s = "
        f"{rounds / wall:.1f} rounds/s (VecFedSim {rounds / vec_wall:.1f});"
        f" host ms a round: engine {out['engine_ms_per_round']:.3f}, codec "
        f"{out['codec_ms_per_round']:.3f}, heap and loop "
        f"{out['heap_ms_per_round']:.3f}; launches {counts}; bytes "
        f"{up}/{down} up/down a round; heap == vec in bytes and "
        f"participants, rel err {errs} | {smi}")
    del heap, vec, rh, rv, state, problem, feats, labels
    torch.cuda.empty_cache()
    return out, counts


def _heap_agreement(torch):
    """Phase 13c: FedSim at n = 5, d = 2,048 for 64 rounds, dasha and
    marina with fused RandK, on the card and on the CPU with the same
    CPU-drawn plans and coins: byte, participant and clock traces equal,
    the metric within 1e-4 relative."""
    import numpy as np
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.fed import FedSim
    from repro_torch.methods import FlatSubstrate, Hyper

    n, m, d, k, rounds, seed = 5, 64, 2048, 32, 64, 11
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    worst = 0.0
    for variant in ("dasha", "marina"):
        res, draws = {}, None
        for dev in ("cpu", "cuda"):
            problem = FiniteSumProblem(_glm_loss(torch), feats.to(dev),
                                       labels.to(dev))
            rc = make_round_compressor("randk", d, n, k=k, backend="fused",
                                       device=dev)
            kw = dict(zeta=float(k), d=d) if variant == "marina" else {}
            hp = Hyper.from_theory(variant, rc.omega, n, L=L,
                                   gamma_mult=4.0, **kw)
            if variant == "marina":
                hp = dataclasses.replace(hp, p=0.2)
            sim = FedSim(variant, rc, FlatSubstrate(problem, n, d), hp,
                         compute_s=0.0, seed=HEAP_SEED, chunk=16,
                         **_heap_links(1.0))
            if draws is None:
                draws = [Draws(plan=RoundRandom(seed, t).plan(rc),
                               sync_coin=RoundRandom(seed, t).coin(
                                   hp.p, "sync")
                               if variant == "marina" else None)
                         for t in range(rounds)]
                state0 = sim.init(torch.zeros(d), seed, device="cpu")
            dev_draws = [_draws_to(dr, dev) for dr in draws]
            state = state0._replace(**{
                f: getattr(state0, f).to(dev)
                for f in ("x", "g", "g_local", "h_local")})
            res[dev] = sim.run(state, rounds, draws=lambda t: dev_draws[t])
        a, b = res["cuda"].traces, res["cpu"].traces
        for key in ("bytes_up", "value_bytes", "bytes_down", "participants",
                    "sync_round", "bits_sent", "sim_wall_clock"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"[heap-agree] {variant}: {key} "
                                     "differs")
        if variant == "marina" and not a["sync_round"].any():
            raise AssertionError("[heap-agree] marina: no sync round")
        if not (np.all(np.isfinite(a["metric"]))
                and np.all(np.isfinite(b["metric"]))):
            raise AssertionError(f"[heap-agree] {variant}: non-finite "
                                 "metric")
        rel = float(np.max(np.abs(a["metric"] - b["metric"])
                           / np.abs(b["metric"])))
        worst = max(worst, rel)
        if not rel <= 1e-4:
            raise AssertionError(f"[heap-agree] {variant}: metric rel err "
                                 f"{rel}")
    log(f"[heap-agree] FedSim dasha/marina, fused RandK K={k}, n={n} "
        f"d={d}, {rounds} rounds, card vs CPU with injected CPU draws: "
        f"bytes/participants/clock equal, metric max rel err {worst:.3g} "
        "(limit 1e-4)")
    return worst


def phase_heap(torch, smi: str):
    """Phase 13: the heap-oracle FedSim on the card (13a, 13b, 13c), each
    part with the launch counts zeroed before its timed run."""
    flat, flat_counts = _heap_campaigns(torch, smi)
    sampled, sampled_counts = _heap_sampled(torch, smi)
    worst = _heap_agreement(torch)
    return ({"real_sim": flat, "sampled": sampled,
             "agreement_worst": worst},
            {"dasha_sparsify_update": flat_counts["dasha_sparsify_update"],
             "quantize": flat_counts["quantize"],
             "slab_writeback": sampled_counts["slab_writeback"]})


def _lanes_agree(got, want, rtol: float):
    """Largest relative error of a sweep lane's trace against a sequential
    run's; raises if their non-finite entries fall in other places."""
    import numpy as np
    bad_got, bad_want = ~np.isfinite(got), ~np.isfinite(want)
    if not np.array_equal(bad_got, bad_want):
        raise AssertionError("non-finite entries in other places: sweep "
                             f"{np.nonzero(bad_got)[0][:5]}, sequential "
                             f"{np.nonzero(bad_want)[0][:5]}")
    ok = ~bad_want
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    if worst > rtol:
        raise AssertionError(f"lane and sequential run differ by {worst:.3g}"
                             f" (limit {rtol})")
    return worst


def _state_errors(torch, got, want, init) -> dict:
    """Each state field's distance between a sweep lane's final state and
    a sequential run's, relative to how far the sequential run moved that
    field from the init state: a lane frozen at x0's state is 1 off, a lane
    run at its neighbour's gamma (2x apart) about 1."""
    out = {}
    for f in SWEEP_STATE:
        a, b, c = (getattr(s, f).double() for s in (got, want, init))
        out[f] = float(torch.linalg.vector_norm(a - b)
                       / torch.linalg.vector_norm(b - c))
    return out


def _state_fault(errs: dict, fields) -> dict:
    """The fields of ``errs`` past SWEEP_STATE_RTOL (NaN counts as past)."""
    return {f: errs[f] for f in fields if not errs[f] <= SWEEP_STATE_RTOL}


def _lane_of(state, j: int):
    """Lane ``j``'s state fields of a sweep's final state."""
    return state._replace(**{f: getattr(state, f)[j] for f in SWEEP_STATE})


def _sweep_equality(torch, variant, sweeper, method_fn, problem, state,
                    gammas, tr, best):
    """Lane equality of one method's sweep against sequential Driver runs
    over SWEEP_EQ_ROUNDS rounds.  Checked: the lowest-gamma lane, the best
    lane and a fast ninth lane (gamma_dasha * 2^SWEEP_FAST) that a sweep of
    the 8 gammas plus it runs.  Each must send the same bits and trace
    ||grad f||^2 within SWEEP_EQ_RTOL; each final iterate must lie within
    SWEEP_STATE_RTOL of the sequential one relative to its move from x0,
    and the fast lane's h_i too (the 8 lanes barely move the gradients, so
    there only x is above the rounding).  g and g_local are reported, not
    gated: they sum the compressed messages, which scale a gradient's
    rounding by d/K.  Then planted faults, a lane frozen at x0, lanes 0
    and 1 swapped and the fast lane's h_i left at x0's, must each fail
    that state gate."""
    import numpy as np
    from repro_torch.methods import Driver
    G, R = len(gammas), SWEEP_EQ_ROUNDS
    fast_gamma = float(gammas[0]) * 2 ** SWEEP_FAST
    eq_gammas = np.append(gammas, fast_gamma)
    fin_eq, tr_eq = sweeper.run(eq_gammas, state, R, device="cuda")
    checks, seq_states = [], {}
    for j in sorted({0, best, G}):
        src = tr if j < G else tr_eq
        drv = Driver(method_fn(float(eq_gammas[j])), metrics={
            "grad_sq": lambda s, _d: torch.sum(problem.grad_f(s.x) ** 2)})
        drv.run(state, 3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seq, tj = drv.run(state, R)
        torch.cuda.synchronize()
        seq_wall = time.perf_counter() - t1
        seq_states[j] = seq
        if not np.array_equal(src["bits_sent"][j, :R], tj["bits_sent"]):
            raise AssertionError(f"[sweep] {variant} lane {j}: bits_sent "
                                 "differ from the sequential run")
        rel = _lanes_agree(src["grad_sq"][j, :R], tj["grad_sq"],
                           SWEEP_EQ_RTOL)
        errs = _state_errors(torch, _lane_of(fin_eq, j), seq, state)
        fields = ("x", "h_local") if j == G else ("x",)
        bad = _state_fault(errs, fields)
        if bad:
            raise AssertionError(f"[sweep] {variant} lane {j}: final state "
                                 f"off the sequential run's by {bad} of its "
                                 f"move from x0 (limit {SWEEP_STATE_RTOL})")
        move = float(torch.linalg.vector_norm(seq.h_local - state.h_local)
                     / torch.linalg.vector_norm(state.h_local))
        checks.append({"lane": j, "gamma": float(eq_gammas[j]),
                       "rounds": R, "wall_s": seq_wall,
                       "rounds_per_s": R / seq_wall, "max_rel_err": rel,
                       "state_rel_err": errs, "gated": list(fields),
                       "h_moved": move})
    if not checks[-1]["h_moved"] >= SWEEP_FAST_MOVE:
        raise AssertionError(f"[sweep] {variant}: the fast lane moved its "
                             f"h_i by {checks[-1]['h_moved']:.3g} of their "
                             f"norm, under {SWEEP_FAST_MOVE}")
    fast = _lane_of(fin_eq, G)
    planted = {
        "lane 0 frozen at x0": (state, seq_states[0], ("x",)),
        "lanes 0 and 1 swapped": (_lane_of(fin_eq, 1), seq_states[0],
                                  ("x",)),
        "fast lane's h_i left at x0": (
            fast._replace(h_local=state.h_local), seq_states[G],
            ("x", "h_local"))}
    caught = {}
    for name, (got, want, fields) in planted.items():
        errs = _state_errors(torch, got, want, state)
        if not _state_fault(errs, fields):
            raise AssertionError(f"[sweep] {variant}: planted fault "
                                 f"'{name}' passes the state gate ({errs})")
        caught[name] = {f: errs[f] for f in fields}
    return checks, caught


def _sweep_method(torch, smi: str, variant, problem, comp, gammas, g0):
    """One fig1 method swept over ``gammas`` at the real-sim shape: the
    timed, counted sweep and its gates, lane equality against sequential
    Driver runs (:func:`_sweep_equality`), and a profiled window.  The
    peak gate is on everything the card holds during the sweep."""
    import numpy as np
    from repro_torch.bench import common as bc
    from repro_torch.bench.fig1_gradient import TARGET_FRAC, bits_to_target
    from repro_torch.core import theory
    from repro_torch.methods import Hyper, Sweeper

    d, k, G, rounds = comp.spec.d, K_RANDK, len(gammas), SWEEP_ROUNDS
    kw = dict(p=theory.marina_p(k, d), batch=0) if variant == "marina" \
        else {}

    def method_fn(gamma):
        return bc.build_method(variant, problem, comp, Hyper(
            gamma=gamma, a=theory.momentum_a(comp.omega), variant=variant,
            **kw))

    state = method_fn(0.0).init(torch.zeros(d, device="cuda"), 1,
                                device="cuda")
    sweeper = Sweeper(method_fn, metrics={
        "grad_sq": bc.metric_of_state(bc.problem_metric(problem))})
    sweeper.run(gammas, state, 3, device="cuda")     # warm-up: cuBLAS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    _, tr = sweeper.run(gammas, state, rounds, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    gs, bits = tr["grad_sq"], tr["bits_sent"]
    if gs.shape != (G, rounds) or bits.shape != (G, rounds):
        raise AssertionError(f"[sweep] {variant}: traces {gs.shape} / "
                             f"{bits.shape}, expected ({G}, {rounds})")
    if counts["dasha_sparsify_update"] != rounds or \
            sum(counts.values()) != rounds:
        raise AssertionError(f"[sweep] {variant}: launches {counts}, "
                             f"expected {rounds} of dasha_sparsify_update "
                             "only (one a round for all lanes)")
    if peak > SWEEP_PEAK_GB:
        raise AssertionError(f"[sweep] {variant}: peak {peak:.2f} GB over "
                             f"{SWEEP_PEAK_GB} GB")
    finals = gs[:, -1]
    finite = np.isfinite(finals)
    if not finite.any():
        raise AssertionError(f"[sweep] {variant}: no lane ended finite")
    best = int(np.argmin(np.where(finite, finals, np.inf)))
    if not finals[best] < g0:
        raise AssertionError(f"[sweep] {variant}: the best lane's "
                             f"||grad f||^2 {finals[best]} is not below its "
                             f"x0 value {g0}")
    seq, caught = _sweep_equality(torch, variant, sweeper, method_fn,
                                  problem, state, gammas, tr, best)
    table, pwall = profiled(torch, lambda: sweeper.run(
        gammas, state, SWEEP_PROFILED, device="cuda"))
    busy = sum(t for _, t in table.values()) / 1e6
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    seq_rps = sum(r["rounds_per_s"] for r in seq) / len(seq)
    out = {"variant": variant, "lanes": G, "rounds": rounds,
           "wall_s": wall, "rounds_per_s": rounds / wall,
           "lane_rounds_per_s": G * rounds / wall,
           "sequential": seq, "sequential_lane_rounds_per_s": seq_rps,
           "speedup_lane_rounds": G * rounds / wall / seq_rps,
           "planted_faults_caught": caught,
           "peak_mem_gb": peak, "launches": counts,
           "gammas": [float(g) for g in gammas],
           "grad_sq_final": [float(v) for v in finals],
           "best_lane": best, "best_gamma": float(gammas[best]),
           "coords_to_eps": bits_to_target(gs[best], bits[best],
                                           TARGET_FRAC * g0),
           "profile": {"rounds": SWEEP_PROFILED, "wall_s": pwall,
                       "device_busy_s": busy, "busy_share": busy / pwall,
                       "top_kernels": [[k_[:90], c, us / 1e3]
                                       for k_, (c, us) in top]}}
    log(f"[sweep] {variant}: {G} lanes x {rounds} rounds in {wall:.2f} s = "
        f"{out['rounds_per_s']:.1f} rounds/s, {out['lane_rounds_per_s']:.1f}"
        f" lane-rounds/s; sequential Driver {seq_rps:.1f} rounds/s "
        f"({out['speedup_lane_rounds']:.2f}x in lane-rounds/s); peak "
        f"{peak:.2f} GB; launches {counts}; best gamma {gammas[best]:.6g} "
        f"(lane {best}), ||grad f||^2 {g0:.6e} -> {finals[best]:.6e}, "
        f"coords to eps {out['coords_to_eps']}; busy "
        f"{out['profile']['busy_share']:.3f} of a profiled "
        f"{SWEEP_PROFILED}-round window | {smi}")
    for r in seq:
        log(f"[sweep]   lane {r['lane']} gamma {r['gamma']:.6g}: "
            f"||grad f||^2 rel err {r['max_rel_err']:.3g}, state rel err "
            f"{ {f: float(f'{e:.3g}') for f, e in r['state_rel_err'].items()} }"
            f" (gated {r['gated']}), h_i moved {r['h_moved']:.3g}")
    for name, errs in caught.items():
        log(f"[sweep]   planted fault '{name}' fails the state gate: "
            f"{ {f: float(f'{e:.3g}') for f, e in errs.items()} }")
    for k_, c, ms in out["profile"]["top_kernels"]:
        log(f"[sweep]   {ms:9.3f} ms  x{c:<5d} {k_}")
    return out, counts["dasha_sparsify_update"]


def _sweep_kernel_row(torch, comp, smi: str):
    """Kernel 1's sparsifier entry against its plain version at the
    sweep's (G * n, d) rows: a real round's n RandK index rows, read at
    row r % n by every lane (no copy), the plan scale d/K and the sweep's
    momentum a."""
    from repro_torch.core import theory
    from repro_torch.core.rng import RoundRandom
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    n, d, G = comp.n, comp.spec.d, SWEEP_G
    plan = RoundRandom(1, 0).plan(comp)
    indices = _path_support(torch, plan, G * n, K_RANDK, "sweep")
    a = theory.momentum_a(comp.omega)
    grad, h, gl, _, _ = _inputs(torch, (G * n, d), 170, False)
    r = _sparsify_row(torch, kern, ref, "sweep", grad, h, gl, a,
                      float(plan.scale), indices, None, cold=True)
    r = {"case": "sweep", "shape": [G * n, d], "misaligned": False,
         "path": "sweep", "a": a, "scale": float(plan.scale), **r}
    log(f"[kernels] dasha_sparsify_update ({G * n}, {d}), the sweep's {G} "
        f"lanes x {n} nodes on {r['s_rows']} index rows: err "
        f"{r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  device "
        f"{r['device_ms']} ms (L2 flushed before each launch: "
        f"{r['device_ms_cold']} ms)  plain {r['plain_ms']:.4f} ms  bound "
        f"{r['bound_ms']:.5f} ms | {smi}")
    return r


def _figures(torch, smi: str):
    """The port's figures and table on the card (``repro_torch.bench``),
    their rows printed; fig1's speedup must exceed 1 and fig5's floors
    must order as the analysis says."""
    import importlib
    from repro_torch.bench.common import emit
    out = {}
    # the fault bench (bench_run.BENCHES' last) runs in phase 15, at the
    # real-sim width
    for name in FIG_ROUNDS_SCALE:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        t0 = time.perf_counter()
        rows = mod.run(device="cuda", rounds_scale=FIG_ROUNDS_SCALE[name])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[figures] {name} at {FIG_ROUNDS_SCALE[name]} x its rounds: "
            f"{dt:.2f} s | {smi}")
        emit(rows)
        out[name] = {"rounds_scale": FIG_ROUNDS_SCALE[name], "wall_s": dt,
                     "rows": rows}
    speedup = out["fig1_gradient"]["rows"][-1]["coords_to_eps"]
    if not speedup > 1.0:
        raise AssertionError(f"[figures] fig1 speedup_dasha_over_marina "
                             f"{speedup} is not above 1")
    floor = out["fig5_quadratic_pl"]["rows"][-1]["grad_sq_floor"]
    if floor != "ok":
        raise AssertionError(f"[figures] fig5 floor_ordering {floor!r}")
    return out


def phase_sweep(torch, smi: str):
    """Phase 14: the stepsize sweep at the real-sim shape (fig1's protocol
    as one sweep of 8 lanes per method), kernel 1 at the sweep's rows, and
    the port's figures on the card.  Returns the report, kernel 1's
    launches on the sweeps and its (G * n, d) row."""
    import numpy as np
    from repro_torch.bench import common as bc
    from repro_torch.core import theory
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification

    n, m, d = N_NODES, M_REALSIM, D_REALSIM
    held = torch.cuda.memory_allocated()
    gc.collect()                    # earlier phases' reference cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[sweep] real-sim-shaped data ({n}, {m}, {d}) = "
        f"{feats.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s; earlier phases hold "
        f"{base / 1e9:.2f} GB ({held / 1e9:.2f} GB before collecting "
        "garbage)")
    problem = FiniteSumProblem(bc.glm_loss, feats, labels)
    L = bc.lipschitz_glm(problem)
    comp = bc.randk_compressor(d, K_RANDK, n, backend="fused",
                               device="cuda")
    g0 = float(torch.sum(problem.grad_f(torch.zeros(d, device="cuda")) ** 2))
    gammas = np.array([theory.gamma_dasha(L, L, comp.omega, n) * 2 ** i
                       for i in range(SWEEP_G)])
    runs, launches = {}, 0
    for variant in ("dasha", "marina"):
        runs[variant], count = _sweep_method(torch, smi, variant, problem,
                                             comp, gammas, g0)
        launches += count
    row = _sweep_kernel_row(torch, comp, smi)
    del feats, labels, problem
    torch.cuda.empty_cache()
    figures = _figures(torch, smi)
    return {"real_sim": runs, "grad_sq_x0": g0,
            "features_gb": n * m * d * 4 / 1e9,
            "held_by_earlier_phases_gb": base / 1e9,
            "held_before_gc_gb": held / 1e9, "figures": figures}, \
        launches, row


def _gate_launches(tag: str, counts: dict, want: dict) -> None:
    """Every wanted kernel launched exactly as often as wanted, and no
    other kernel at all."""
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"[{tag}] launches {counts}, expected {want}")


def _launch_counts():
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import slab_writeback as slab_kern
    from repro_torch.kernels import ssd_chunk as ssd_kern
    return {**kern.COUNTS, **slab_kern.COUNTS, **ssd_kern.COUNTS}


def _reset_launch_counts():
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import slab_writeback as slab_kern
    from repro_torch.kernels import ssd_chunk as ssd_kern
    for mod in (kern, slab_kern, ssd_kern):
        mod.reset_counts()


def _fault_models(clock):
    """Two FaultModel subclasses: one that adds the host seconds of its
    campaign draw to ``clock["faults_s"]``, and the planted fault, whose
    campaign has its ``drop_up`` shifted by one round."""
    import numpy as np
    from repro_torch.fed import FaultModel

    @dataclasses.dataclass(frozen=True)
    class Timed(FaultModel):
        def draw_campaign(self, rounds, n, *, retries=False):
            t0 = time.perf_counter()
            out = super().draw_campaign(rounds, n, retries=retries)
            clock["faults_s"] += time.perf_counter() - t0
            return out

    @dataclasses.dataclass(frozen=True)
    class Shifted(FaultModel):
        def draw_campaign(self, rounds, n, *, retries=False):
            fc = super().draw_campaign(rounds, n, retries=retries)
            return fc._replace(drop_up=np.roll(fc.drop_up, 1, axis=0))

    return Timed, Shifted


def _watch_faulted_heap(sim, clock):
    """Instrument one faulted FedSim instance: host seconds in the engine's
    chunks and in the codec plus the integrity drill, and the uploads the
    drill verified and the corrupted ones it caught (it raises on a miss).
    :func:`_unwatch_heap`'s counterpart removes the attributes again."""
    run_chunk, round_wire = sim._run_chunk, sim._round_wire
    verify = sim._verify_round_buffers

    def timed_chunk(*args):
        t0 = time.perf_counter()
        out = run_chunk(*args)
        clock["engine_s"] += time.perf_counter() - t0
        return out

    def timed_wire(*args, **kw):
        t0 = time.perf_counter()
        out = round_wire(*args, **kw)
        clock["codec_s"] += time.perf_counter() - t0
        return out

    def timed_verify(bufs, t, senders, fc):
        t0 = time.perf_counter()
        verify(bufs, t, senders, fc)
        clock["codec_s"] += time.perf_counter() - t0
        arrive = senders & ~fc.drop_up[t]
        clock["verified"] += int(arrive.sum())
        clock["caught"] += int((arrive & fc.corrupt[t]).sum())

    sim._run_chunk, sim._round_wire = timed_chunk, timed_wire
    sim._verify_round_buffers = timed_verify


def _unwatch_faulted_heap(sim):
    del sim._run_chunk, sim._round_wire, sim._verify_round_buffers


def _faults_sweep(torch, smi: str, problem):
    """Phase 15a: fed_faults_bench's degradation sweep through VecFedSim at
    the real-sim width, fused RandK K = 100 (kernel 1): the drop grid
    {0, 0.05, 0.1, 0.2} x {dasha, marina}, 240 rounds each, ||grad f||^2
    every round.  Gates: the bench's four, every campaign dropped some
    round, kernel 1 once a round; then a profiled 128-round chunk."""
    from repro_torch.bench import common as bc
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.methods import FlatSubstrate

    n, m, d = (int(v) for v in problem.features.shape)
    rounds, k = FAULT_ROUNDS, K_RANDK
    kw = dict(k=k, backend="fused", device="cuda")
    ff.degradation_sweep(problem, rounds=2, **kw)   # warm-up, not counted
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    rep = ff.degradation_sweep(problem, rounds=rounds, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    campaigns = len(ff.DROP_GRID) * 2
    _gate_launches("faults", counts, {"dasha_sparsify_update": campaigns * rounds})
    gates = ("marina_math_invariant", "dasha_metric_within_factor",
             "dasha_wall_bounded_by_deadline",
             "marina_pays_in_time_and_bytes", "graceful_degradation_ok")
    failed = [g for g in gates if rep[g] is not True]
    if failed:
        raise AssertionError(f"[faults] degradation gates failed: {failed}; "
                             f"wall inflation {rep['wall_inflation']}")
    rows = []
    for g in rep["grid"]:
        for v in ("dasha", "marina"):
            r = g[v]
            if not r["dropped_rounds"] > 0:
                raise AssertionError(f"[faults] {v} at p_drop "
                                     f"{g['p_drop_up']}: no round dropped "
                                     "a client")
            rows.append({"variant": v, "p_drop_up": g["p_drop_up"],
                         "rounds_per_s": rounds / r["host_s"], **r})
    # where a chunk's time goes: a dasha chunk at 10% loss
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, **kw)
    hp = bc.theory_hyper("dasha", rc.omega, bc.lipschitz_glm(problem), d=d,
                         k=k, n=n, m=m)
    table, pwall = profiled(torch, lambda: ff.run_campaign(
        "dasha", rc, sub, hp, ff.fault_model(0.1), FED_CHUNK))
    busy = sum(t for _, t in table.values()) / 1e6
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    out = {**{k_: v for k_, v in rep.items() if k_ != "grid"},
           "campaigns": rows, "wall_s": wall, "launches": counts,
           "profiled_chunk": {
               "campaign": "dasha p_drop_up=0.1", "rounds": FED_CHUNK,
               "wall_s": pwall, "device_busy_s": busy,
               "busy_share": busy / pwall,
               "top_kernels": [[k_[:90], c, us / 1e3]
                               for k_, (c, us) in top]}}
    for r in rows:
        log(f"[faults] {r['variant']} p_drop_up={r['p_drop_up']}: {rounds} "
            f"rounds in {r['host_s']:.3f} s = {r['rounds_per_s']:.1f} "
            f"rounds/s; simulated {r['wall_clock_s']:.4f} s, "
            f"{r['bytes_up']} bytes up ({r['wasted_bytes_up']} wasted), "
            f"{r['dropped_rounds']} rounds dropped a client, "
            f"{r['retries']} retries, final ||grad f||^2 "
            f"{r['final_metric']:.6e} | {smi}")
    log(f"[faults] wall inflation {rep['wall_inflation']}; gates "
        f"{ {g: rep[g] for g in gates} }; launches {counts}")
    log(f"[faults] profiled dasha chunk: {pwall * 1e3:.1f} ms wall, device "
        f"busy {busy / pwall:.3f} | {smi}")
    for k_, c, ms in out["profiled_chunk"]["top_kernels"]:
        log(f"[faults]   {ms:9.3f} ms  x{c:<5d} {k_}")
    return out, counts


def _faults_heap_vec(torch, smi: str, problem):
    """Phase 15b and 15c: heap == vec at the real-sim width, 40 rounds a
    campaign: dasha under the tests' FM_MIXED (reset rejoins) and marina
    under FM_SYNC with fused RandK (kernel 1), and dasha under FM_MIXED
    with fused QDither s = 15 (kernel 2).  Every arriving upload is
    verified and every corrupted one caught (FedSim's drill raises on a
    miss).  Gates: the integer traces equal, the wall clock within 2e-6
    and the metric within 1e-4 relative, ||g - mean_i g_i|| <= 1e-5 ||g||
    after a reset campaign; a planted fault (drop_up shifted by a round)
    must fail the integer gate."""
    from repro_torch.bench import common as bc
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FedSim, VecFedSim
    from repro_torch.methods import FlatSubstrate

    n, m, d = (int(v) for v in problem.features.shape)
    rounds, k = FAULT_EQ_ROUNDS, K_RANDK
    sub = FlatSubstrate(problem, n, d)
    L = bc.lipschitz_glm(problem)
    clock = {"faults_s": 0.0, "engine_s": 0.0, "codec_s": 0.0,
             "verified": 0, "caught": 0}
    Timed, Shifted = _fault_models(clock)
    comps = {"randk": make_round_compressor("randk", d, n, k=k,
                                            backend="fused", device="cuda"),
             "qdither": make_round_compressor("qdither", d, n, s=S_QDITHER,
                                              backend="fused",
                                              device="cuda")}
    campaigns = [("dasha", "randk", "dasha"), ("marina", "randk", "marina"),
                 ("dasha", "qdither", "dasha")]

    def make(cls, variant, comp, fm):
        hp = bc.theory_hyper(variant, comps[comp].omega, L, d=d, k=k, n=n,
                             m=m)
        return cls(variant, comps[comp], sub, hp, compute_s=0.0,
                   seed=ff.NET_SEED, faults=fm, **ff.links())

    state = make(FedSim, "dasha", "randk", None).init(
        torch.zeros(d, device="cuda"), 1, device="cuda")
    for variant, comp, fkey in campaigns:            # warm-up, not counted
        for cls in (FedSim, VecFedSim):
            make(cls, variant, comp,
                 Timed(**ff.EQUIV_FAULTS[fkey])).run(state, 2)
    torch.cuda.synchronize()
    _reset_launch_counts()
    rows, results = [], {}
    for variant, comp, fkey in campaigns:
        fkw = ff.EQUIV_FAULTS[fkey]
        for key in clock:
            clock[key] = 0 if isinstance(clock[key], int) else 0.0
        heap = make(FedSim, variant, comp, Timed(**fkw))
        _watch_faulted_heap(heap, clock)
        t0 = time.perf_counter()
        rh = heap.run(state, rounds)
        hwall = time.perf_counter() - t0
        _unwatch_faulted_heap(heap)
        split = dict(clock)
        t0 = time.perf_counter()
        rv = make(VecFedSim, variant, comp, Timed(**fkw)).run(state, rounds)
        torch.cuda.synchronize()
        vwall = time.perf_counter() - t0
        cmp = ff.compare_heap_vec(rh, rv)
        tag = f"[faults] heap vs vec {variant} {comp}"
        if not cmp["integer_traces_bit_exact"]:
            bad = [t for t, ok in cmp["integer_traces"].items() if not ok]
            raise AssertionError(f"{tag}: integer traces differ: {bad}")
        if not (cmp["wall_clock_rel_err"] <= FAULT_WALL_RTOL
                and cmp["metric_rel_err"] <= FAULT_METRIC_RTOL):
            raise AssertionError(f"{tag}: wall clock rel err "
                                 f"{cmp['wall_clock_rel_err']}, metric "
                                 f"{cmp['metric_rel_err']}")
        if not (rh.summary["dropped_rounds"] > 0 and split["caught"] > 0):
            raise AssertionError(f"{tag}: no dropped round or no corrupted "
                                 f"upload caught ({split})")
        invariant = {}
        if fkw.get("rejoin") == "reset":
            if not rh.traces["rejoins"].sum() > 0:
                raise AssertionError(f"{tag}: no reset rejoin")
            for eng, res in (("heap", rh), ("vec", rv)):
                g = res.state.g
                gap = float(torch.linalg.vector_norm(
                    g - res.state.g_local.mean(0))
                    / torch.linalg.vector_norm(g))
                invariant[eng] = gap
                if not gap <= FAULT_INVARIANT:
                    raise AssertionError(f"{tag}: ||g - mean g_i|| = "
                                         f"{gap:.3g} ||g|| on the {eng}")
        results[variant, comp] = rh
        row = {"variant": variant, "compressor": comp, "faults": fkw,
               "rounds": rounds, "heap_wall_s": hwall,
               "heap_rounds_per_s": rounds / hwall,
               "vec_wall_s": vwall, "vec_rounds_per_s": rounds / vwall,
               "heap_ms_per_round": {
                   "fault_realization": split["faults_s"] / rounds * 1e3,
                   "engine": split["engine_s"] / rounds * 1e3,
                   "codec_and_verify": split["codec_s"] / rounds * 1e3,
                   "rest": (hwall - split["faults_s"] - split["engine_s"]
                            - split["codec_s"]) / rounds * 1e3},
               "uploads_verified": split["verified"],
               "corrupted_caught": split["caught"],
               "dropped_rounds": rh.summary["dropped_rounds"],
               "retries": rh.summary["retries"],
               "sim_wall_clock_s": rh.summary["wall_clock_s"],
               "wall_clock_rel_err": cmp["wall_clock_rel_err"],
               "metric_rel_err": cmp["metric_rel_err"],
               "server_invariant": invariant}
        rows.append(row)
        hm = row["heap_ms_per_round"]
        log(f"{tag}: {rounds} rounds, heap {row['heap_rounds_per_s']:.1f} "
            f"rounds/s (host ms a round: faults "
            f"{hm['fault_realization']:.3f}, engine {hm['engine']:.3f}, "
            f"codec+verify {hm['codec_and_verify']:.3f}, rest "
            f"{hm['rest']:.3f}), vec {row['vec_rounds_per_s']:.1f} rounds/s;"
            f" integer traces equal, wall rel err "
            f"{cmp['wall_clock_rel_err']:.3g}, metric rel err "
            f"{cmp['metric_rel_err']:.3g}; {split['verified']} uploads "
            f"verified, {split['caught']} corrupted caught; "
            f"{int(rh.summary['dropped_rounds'])} rounds dropped a client, "
            f"{int(rh.summary['retries'])} retries; invariant {invariant} "
            f"| {smi}")
    # the planted fault: the vec simulator on a campaign whose drop_up is
    # one round late must fail the integer gate
    planted = make(VecFedSim, "dasha", "randk",
                   Shifted(**ff.EQUIV_FAULTS["dasha"])).run(state, rounds)
    cmp = ff.compare_heap_vec(results["dasha", "randk"], planted)
    if cmp["integer_traces_bit_exact"]:
        raise AssertionError("[faults] the planted fault (drop_up one "
                             "round late) passed the integer-trace gate")
    caught = sorted(t for t, ok in cmp["integer_traces"].items() if not ok)
    log(f"[faults] planted fault (drop_up one round late) fails the "
        f"integer gate on {caught}")
    counts = _launch_counts()
    fused_randk = 2 * 2 + 1            # heap and vec x 2, and the planted
    _gate_launches("faults", counts,
                   {"dasha_sparsify_update": fused_randk * rounds,
                    "quantize": 2 * rounds})
    return {"campaigns": rows, "planted_fault_fails_on": caught,
            "launches": counts}, counts


def _faults_kernel_rows(torch, smi: str, problem):
    """Phase 15 kernel rows: kernels 1 and 2 against their plain versions
    at the faulted campaigns' (n, d) rows, gated as phase 2 gates them
    (kernel 1 bit-equal, kernel 2 the one-level rule): kernel 1's
    sparsifier entry on a real round's RandK indices at the plan scale d/K
    with the campaigns' momentum a, kernel 2 at s = 15."""
    from repro_torch.bench import common as bc
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.rng import RoundRandom
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref

    n, m, d = (int(v) for v in problem.features.shape)
    rc = make_round_compressor("randk", d, n, k=K_RANDK, backend="fused",
                               device="cuda")
    a = bc.theory_hyper("dasha", rc.omega, bc.lipschitz_glm(problem), d=d,
                        k=K_RANDK, n=n, m=m).a
    plan = RoundRandom(1, 0).plan(rc)
    indices = _path_support(torch, plan, n, K_RANDK, "faults")
    scale = float(plan.scale)
    grad, h, gl, _, _ = _inputs(torch, (n, d), 180, False)
    r1 = _sparsify_row(torch, kern, ref, "faults", grad, h, gl, a, scale,
                       indices, None, cold=True)
    del grad, h, gl
    r1 = {"case": "faults", "shape": [n, d], "misaligned": False,
          "path": "faults", "a": a, "scale": scale, **r1}
    r2 = _check_quantize(torch, kern, ref, (n, d), False, 181)
    r2 = {"shape": [n, d], "misaligned": False, "path": "faults",
          "levels": S_QDITHER, **r2}
    for name, r in (("dasha_sparsify_update", r1), ("quantize", r2)):
        cold = f" (L2 flushed before each launch: {r['device_ms_cold']} ms)" \
            if "device_ms_cold" in r else ""
        log(f"[kernels] {name} ({n}, {d}) at the faulted campaigns' rows: "
            f"err {r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  device "
            f"{r['device_ms']} ms{cold}  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms | {smi}")
    return {"dasha_sparsify_update": r1, "quantize": r2}


def _dasha_round_by_hand(torch, problem, rc, hp, st, drop, reset):
    """One faulted DASHA round with RandK, written out in plain tensor ops
    apart from the engine: x+ = x - gamma g, h_i+ = grad f_i(x+); a reset
    client starts from h_i = g_i = 0 and the server forgets its g_i / n;
    m_i = mask_i (h_i+ - h_i - a (g_i - h_i)) d/K reaches the server and
    commits only where the client is not dropped.  Returns the round's
    state and, for each field, how far the round could move it: the step
    for x, the magnitudes summed into g, and per row max |h_i+ - h_i| and
    max |m_i|."""
    from repro_torch.compress.plan import indices_to_masks
    from repro_torch.core.rng import RoundRandom

    n, d = st.g_local.shape
    x = st.x - hp.gamma * st.g
    grads = problem.full_grad(x)
    plan = RoundRandom(st.seed, st.t).plan(rc)
    mask = plan.mask.to(torch.float32) if plan.mask is not None \
        else indices_to_masks(plan.indices, d)
    rst = (torch.zeros_like(drop) if reset is None else reset)[:, None]
    keep = ~drop[:, None]
    zero = torch.zeros_like(st.g_local)
    h = torch.where(rst, zero, st.h_local)
    gl = torch.where(rst, zero, st.g_local)
    msg = mask * (grads - h - hp.a * (gl - h)) * plan.scale
    sent = torch.where(keep, msg, zero).sum(0) / n
    forgot = torch.where(rst, st.g_local, zero).sum(0) / n
    want = {"x": x, "g": st.g + sent - forgot,
            "h_local": torch.where(keep, grads, h),
            "g_local": torch.where(keep, gl + msg, gl)}
    reach = {"x": (x - st.x).abs().max(),
             "g": (st.g.abs() + sent.abs() + forgot.abs()).max(),
             "h_local": (grads - h).abs().amax(1),
             "g_local": msg.abs().amax(1)}
    return want, reach


def _faults_by_hand(torch, smi: str, problem):
    """Phase 15e: the faulted DASHA arithmetic at the real-sim width held
    against :func:`_dasha_round_by_hand`.  15b's dasha campaign (FM_MIXED,
    reset rejoins, fused RandK) runs through VecFedSim once more, and each
    engine step's output is compared with the hand-written round on that
    step's own input state and fault masks: x, g, g_local and h_local
    within FAULT_HAND_LIMIT of how far the round could move them (per row
    for the node tensors).  Rounds with drops and with resets must occur;
    a planted fault, the first dropped client's round committed, must
    fail the limit."""
    from repro_torch.bench import common as bc
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FaultModel, VecFedSim
    from repro_torch.methods import FlatSubstrate

    n, m, d = (int(v) for v in problem.features.shape)
    rc = make_round_compressor("randk", d, n, k=K_RANDK, backend="fused",
                               device="cuda")
    hp = bc.theory_hyper("dasha", rc.omega, bc.lipschitz_glm(problem), d=d,
                         k=K_RANDK, n=n, m=m)
    sim = VecFedSim("dasha", rc, FlatSubstrate(problem, n, d), hp,
                    compute_s=0.0, seed=ff.NET_SEED,
                    faults=FaultModel(**ff.EQUIV_FAULTS["dasha"]),
                    **ff.links())
    fields = ("x", "g", "g_local", "h_local")
    worst = dict.fromkeys(fields, 0.0)
    seen = {"rounds": 0, "drop_rounds": 0, "reset_rounds": 0}
    planted = {}

    def errors(got, want, reach):
        out = {}
        for f in fields:
            diff = (getattr(got, f) - want[f]).abs()
            if diff.dim() == 2:            # per row, in that row's reach
                diff = diff.amax(1) / reach[f].clamp_min(1e-30)
            else:
                diff = diff / reach[f]
            out[f] = float(diff.max())
        return out

    method = sim.method

    class HandChecked:
        def __getattr__(self, name):
            return getattr(method, name)

        def step_full(self, st, data, **kw):
            new, info = method.step_full(st, data, **kw)
            f = kw["faults"]
            want, reach = _dasha_round_by_hand(torch, problem, rc, sim.hyper,
                                               st, f.drop, f.reset)
            for k_, e in errors(new, want, reach).items():
                worst[k_] = max(worst[k_], e)
            seen["rounds"] += 1
            seen["drop_rounds"] += int(bool(f.drop.any()))
            seen["reset_rounds"] += int(f.reset is not None
                                        and bool(f.reset.any()))
            if not planted and bool(f.drop.any()):
                wrong = f.drop.clone()
                wrong[int(torch.nonzero(f.drop)[0])] = False
                planted.update(errors(new, *_dasha_round_by_hand(
                    torch, problem, rc, sim.hyper, st, wrong, f.reset)))
            return new, info

    sim.method = HandChecked()
    sim.run(sim.init(torch.zeros(d, device="cuda"), 1, device="cuda"),
            FAULT_EQ_ROUNDS)
    sim.method = method
    tag = "[faults-hand]"
    if not (seen["rounds"] == FAULT_EQ_ROUNDS and seen["drop_rounds"] > 0
            and seen["reset_rounds"] > 0):
        raise AssertionError(f"{tag} rounds checked {seen}: want every "
                             "round, some with drops and some with resets")
    if not all(e <= FAULT_HAND_LIMIT for e in worst.values()):
        raise AssertionError(f"{tag} engine against the hand-written "
                             f"round: {worst} (limit {FAULT_HAND_LIMIT})")
    if max(planted.values()) <= FAULT_HAND_LIMIT:
        raise AssertionError(f"{tag} the planted fault (a dropped client's "
                             f"round committed) passed: {planted}")
    log(f"{tag} dasha FM_MIXED fused RandK ({n}, {m}, {d}), {seen}: "
        f"worst error in units of the round's reach {worst} (limit "
        f"{FAULT_HAND_LIMIT}); the planted fault gives {planted} | {smi}")
    return {"rounds": seen, "worst": worst, "planted": planted,
            "limit": FAULT_HAND_LIMIT}


def _faults_agreement(torch):
    """Phase 15d: at n = 5, m = 32, d = 40, fused RandK K = 6, a faulted
    dasha (FM_MIXED, reset rejoins) and a faulted marina (FM_SYNC), each
    through FedSim and VecFedSim on the card and on the CPU with the same
    CPU-drawn plans and coins: integer traces equal, the metric, the wall
    clock and the final x within 1e-4 relative."""
    import numpy as np
    from repro_torch.bench import common as bc
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.fed import FaultModel, FedSim, VecFedSim
    from repro_torch.methods import FlatSubstrate

    n, m, d = FAULT_SMALL
    k, rounds, seed = FAULT_SMALL_K, FAULT_EQ_ROUNDS, 11
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = bc.lipschitz_glm(FiniteSumProblem(bc.glm_loss, feats, labels))
    worst = 0.0
    for variant in ("dasha", "marina"):
        for cls in (FedSim, VecFedSim):
            res, draws = {}, None
            for dev in ("cpu", "cuda"):
                problem = FiniteSumProblem(bc.glm_loss, feats.to(dev),
                                           labels.to(dev))
                rc = make_round_compressor("randk", d, n, k=k,
                                           backend="fused", device=dev)
                hp = bc.theory_hyper(variant, rc.omega, L, d=d, k=k, n=n,
                                     m=m)
                sim = cls(variant, rc, FlatSubstrate(problem, n, d), hp,
                          compute_s=0.0, seed=ff.NET_SEED, chunk=16,
                          faults=FaultModel(**ff.EQUIV_FAULTS[variant]),
                          **ff.links())
                if draws is None:
                    draws = [Draws(plan=RoundRandom(seed, t).plan(rc),
                                   sync_coin=RoundRandom(seed, t).coin(
                                       hp.p, "sync")
                                   if variant == "marina" else None)
                             for t in range(rounds)]
                    state0 = sim.init(torch.zeros(d), seed, device="cpu")
                dev_draws = [_draws_to(dr, dev) for dr in draws]
                state = state0._replace(**{
                    f: getattr(state0, f).to(dev)
                    for f in ("x", "g", "g_local", "h_local")})
                res[dev] = sim.run(state, rounds,
                                   draws=lambda t: dev_draws[t])
            a, b = res["cuda"], res["cpu"]
            tag = f"[faults-agree] {variant} {cls.__name__}"
            for key in ff.INT_TRACES:
                if not np.array_equal(a.traces[key], b.traces[key]):
                    raise AssertionError(f"{tag}: {key} differs")
            if not b.summary["dropped_rounds"] > 0:
                raise AssertionError(f"{tag}: no round dropped a client")
            errs = {key: float(np.max(np.abs(a.traces[key] - b.traces[key])
                                      / np.abs(b.traces[key])))
                    for key in ("metric", "sim_wall_clock")}
            x_a, x_b = a.state.x.cpu(), b.state.x
            errs["x"] = float(torch.max(torch.abs(x_a - x_b))
                              / torch.max(torch.abs(x_b)))
            if not all(np.isfinite(e) and e <= 1e-4 for e in errs.values()):
                raise AssertionError(f"{tag}: rel errs {errs} (limit 1e-4)")
            worst = max(worst, *errs.values())
    log(f"[faults-agree] FedSim/VecFedSim dasha (reset) and marina, fused "
        f"RandK K={k}, n={n} d={d}, {rounds} rounds, card vs CPU with "
        f"injected CPU draws: integer traces equal, worst rel err "
        f"{worst:.3g} (limit 1e-4)")
    return worst


def phase_faults(torch, smi: str):
    """Phase 15: faulted campaigns at the real-sim width (15a the
    degradation sweep, 15b/c heap == vec with kernels 1 and 2, 15e the
    engine's faulted rounds against hand-written ones), the absolute peak
    gated at 8 GB, kernels 1 and 2 against their plain versions at the
    campaigns' rows, then card vs CPU at a small shape (15d).  Returns
    the report, the faulted path's launches of kernels 1 and 2, and their
    kernel rows."""
    from repro_torch.bench import fed_faults as ff

    n, m, d = FAULT_N, FAULT_M, D_REALSIM
    gc.collect()                    # earlier phases' reference cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    problem = ff.make_problem(d, n, m, device="cuda")
    torch.cuda.synchronize()
    log(f"[faults] real-sim-width data ({n}, {m}, {d}) = "
        f"{problem.features.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s; earlier phases hold "
        f"{base / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    sweep, sweep_counts = _faults_sweep(torch, smi, problem)
    equiv, equiv_counts = _faults_heap_vec(torch, smi, problem)
    by_hand = _faults_by_hand(torch, smi, problem)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if peak > FAULT_PEAK_GB:
        raise AssertionError(f"[faults] peak {peak:.2f} GB over "
                             f"{FAULT_PEAK_GB} GB")
    log(f"[faults] peak {peak:.2f} GB with all that the card holds "
        f"(gate {FAULT_PEAK_GB} GB) | {smi}")
    kernel_rows = _faults_kernel_rows(torch, smi, problem)
    del problem
    torch.cuda.empty_cache()
    worst = _faults_agreement(torch)
    launches = {"dasha_sparsify_update": sweep_counts["dasha_sparsify_update"]
                + equiv_counts["dasha_sparsify_update"],
                "quantize": equiv_counts["quantize"]}
    return {"n": n, "m": m, "d": d, "K": K_RANDK, "s_qdither": S_QDITHER,
            "features_gb": n * m * d * 4 / 1e9,
            "held_by_earlier_phases_gb": base / 1e9, "peak_mem_gb": peak,
            "links": {"up_Bps": ff.UP_BW, "down_Bps": ff.DOWN_BW,
                      "latency_s": ff.LATENCY, "compute_s": 0.0,
                      "net_seed": ff.NET_SEED},
            "sweep": sweep, "heap_vs_vec": equiv, "by_hand": by_hand,
            "agreement_worst": worst, "launches": launches,
            "nvidia_smi": smi}, launches, kernel_rows


def _async_sweep(torch, smi: str, problem):
    """Phase 16a: fed_async_bench's severity sweep and tau sweep through
    VecFedSim at the real-sim width, fused RandK K = 100 (kernel 1): tau =
    2, sigma in {0, 1, 2}, dasha and marina (p = 0.15), barrier and
    async, 300 rounds each; tau in {0, 1, 2, 4} at sigma = 2 over 150
    rounds.  Gates: the bench's five, the tau sweep monotone, kernel 1
    once a round and nothing else; then tau = 0 against the sweep's
    sigma = 2 barrier runs bit for bit (every trace and the final state)
    for both variants, and a profiled 128-round async dasha chunk."""
    import numpy as np
    from repro_torch.bench import fed_async as fa

    n, m, d = (int(v) for v in problem.features.shape)
    kw = dict(k=K_RANDK, backend="fused", device="cuda")
    fa.severity_sweep(problem, rounds=2, sigmas=(0.0,), **kw)  # warm-up
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    sev = fa.severity_sweep(problem, rounds=ASYNC_ROUNDS,
                            sigmas=ASYNC_SIGMAS, tau=ASYNC_TAU,
                            keep_runs=True, **kw)
    depth = fa.tau_sweep(problem, rounds=ASYNC_ROUNDS,
                         sigma=max(ASYNC_SIGMAS), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    runs = sev.pop("runs")
    rounds = 2 * 2 * len(ASYNC_SIGMAS) * ASYNC_ROUNDS \
        + len(depth["taus"]) * depth["rounds"]
    _gate_launches("async", counts, {"dasha_sparsify_update": rounds})
    gates = ("dasha_async_strictly_faster", "advantage_widens_with_severity",
             "marina_capped_by_coin_flush",
             "bytes_up_bit_identical_async_vs_barrier", "payload_reconciles")
    failed = [g for g in gates if sev[g] is not True]
    if not depth["monotone_nonincreasing"]:
        failed.append("tau_sweep_monotone_nonincreasing")
    if failed:
        raise AssertionError(f"[async] gates failed: {failed}; ratios "
                             f"{sev['async_over_barrier_ratio']}, tau sweep "
                             f"{depth['wall_clock_s']}")
    if sev["sync_rounds_async"]["dasha"] != 0 or \
            not sev["sync_rounds_async"]["marina"] > 0:
        raise AssertionError(f"[async] sync rounds "
                             f"{sev['sync_rounds_async']}")
    for v in runs:
        for r in runs[v]["barrier"] + runs[v]["async"]:
            tr = r.traces
            if not all(np.isfinite(tr[k]).all() and tr[k].shape ==
                       (ASYNC_ROUNDS,) for k in ("metric", "sim_wall_clock",
                                                 "bcast_clock")):
                raise AssertionError(f"[async] {v}: a non-finite or "
                                     "misshapen trace")

    # tau = 0 is the barrier on the card, bit for bit
    k, sub, rc, L = fa.campaign_setup(problem, "fused", K_RANDK)[3:]
    hyper = {v: fa.bench_hyper(v, rc.omega, L, d=d, k=k, n=n, m=m)
             for v in ("dasha", "marina")}
    top = len(ASYNC_SIGMAS) - 1
    for v, hp in hyper.items():
        r0, _ = fa.run_campaign(v, rc, sub, hp, ASYNC_SIGMAS[top], 0,
                                ASYNC_ROUNDS)
        if not fa.same_run(runs[v]["barrier"][top], r0):
            raise AssertionError(f"[async] {v}: tau = 0 differs from the "
                                 "barrier run on the card")
    del runs

    rates = {v: {mode: [ASYNC_ROUNDS / s for s in sev["host_s"][v][mode]]
                 for mode in ("barrier", "async")} for v in hyper}
    table, pwall = profiled(torch, lambda: fa.run_campaign(
        "dasha", rc, sub, hyper["dasha"], ASYNC_SIGMAS[top], ASYNC_TAU,
        FED_CHUNK))
    busy = sum(t for _, t in table.values()) / 1e6
    top_k = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    out = {**sev, "tau_sweep": depth, "rounds_per_s": rates,
           "wall_s": wall, "launches": counts,
           "tau0_equals_barrier_on_the_card": True,
           "profiled_chunk": {
               "campaign": f"dasha tau={ASYNC_TAU} "
                           f"sigma={ASYNC_SIGMAS[top]}",
               "rounds": FED_CHUNK, "wall_s": pwall,
               "device_busy_s": busy, "busy_share": busy / pwall,
               "top_kernels": [[k_[:90], c, us / 1e3]
                               for k_, (c, us) in top_k]}}
    for v in hyper:
        for i, s in enumerate(ASYNC_SIGMAS):
            log(f"[async] {v} sigma={s}: barrier "
                f"{rates[v]['barrier'][i]:.1f} rounds/s, async "
                f"{rates[v]['async'][i]:.1f} rounds/s; wall to target "
                f"{sev['wall_to_target_s'][v]['barrier'][i]:.4f} -> "
                f"{sev['wall_to_target_s'][v]['async'][i]:.4f} s (ratio "
                f"{sev['async_over_barrier_ratio'][v][i]:.4f}) | {smi}")
    log(f"[async] tau sweep at sigma {depth['sigma']}: "
        f"{dict(zip(depth['taus'], depth['wall_clock_s']))}; gates "
        f"{ {g: sev[g] for g in gates} }; tau = 0 == barrier bit for bit "
        f"(dasha, marina); launches {counts}")
    log(f"[async] profiled async dasha chunk: {pwall * 1e3:.1f} ms wall, "
        f"device busy {busy / pwall:.3f} | {smi}")
    for k_, c, ms in out["profiled_chunk"]["top_kernels"]:
        log(f"[async]   {ms:9.3f} ms  x{c:<5d} {k_}")
    return out, counts


def _deficit_by_hand(torch, snap, x_t, g_t, gamma: float, n: int,
                     plant=None):
    """x_{t+1} = x_t - gamma (g_t - deficit_t) in float64 on the host from
    a snapshot of the pipeline before the round: the broadcast's advance,
    the in-flight set (landings after it) and the deficit, recomputed from
    the ring.  ``plant`` corrupts it on purpose: "shift" takes each ring
    slot's in-flight mask from its neighbour, "sign" adds the deficit."""
    adv = max(max(float(snap["floors"][0]), float(snap["flush"])), 0.0)
    in_flight = (snap["arrivals"][1:] - adv) > 0.0          # (tau, n)
    mask = torch.gather(in_flight, 1, snap["ids"])          # (tau, C)
    if plant == "shift":
        mask = torch.roll(mask, 1, 0)
    deficit = torch.where(mask[..., None], snap["msgs"],
                          torch.zeros((), dtype=torch.float64)).sum((0, 1))
    deficit = deficit / n
    sign = -1.0 if plant == "sign" else 1.0
    return x_t - gamma * (g_t - sign * deficit), deficit


def _async_deficit_check(torch, smi: str, problem):
    """Phase 16b, first part: 16a's async dasha campaign (tau = 2, sigma =
    2) for ASYNC_CHECK_ROUNDS rounds through VecFedSim, each round's x
    held against :func:`_deficit_by_hand` on a float64 snapshot of the
    pipeline taken before it, every coordinate within ASYNC_DEFICIT_LIMIT
    x gamma max|deficit_t| plus ASYNC_ULPS float32 ulps of the terms the
    card rounds, over the rounds with a deficit, which must occur.  The
    error is reported in units of that bound.  Two planted faults, the
    in-flight mask shifted by one ring slot and the deficit's sign
    flipped, must each exceed it."""
    from repro_torch.bench import fed_async as fa
    from repro_torch.fed import VecFedSim

    n, m, d = (int(v) for v in problem.features.shape)
    k, sub, rc, L = fa.campaign_setup(problem, "fused", K_RANDK)[3:]
    hp = fa.bench_hyper("dasha", rc.omega, L, d=d, k=k, n=n, m=m)
    sim = VecFedSim("dasha", rc, sub, hp, compute_s=0.0, seed=fa.SEED,
                    tau=ASYNC_TAU, **fa.links(max(ASYNC_SIGMAS)))
    worst = {"engine": 0.0, "shift": 0.0, "sign": 0.0}
    seen = {"rounds": 0, "with_deficit": 0}
    orig = sim._round_scatter

    def checked(st, m_down, m_up, draws, metric_fn, pipe=None, ids=None):
        f64 = torch.float64
        snap = {f: getattr(pipe, f).to(f64).cpu()
                for f in ("floors", "flush", "arrivals", "msgs")}
        snap["ids"] = pipe.ids.cpu()
        x_t, g_t = st.x.to(f64).cpu(), st.g.to(f64).cpu()
        new, coin, vals = orig(st, m_down, m_up, draws, metric_fn, pipe,
                               ids)
        x_card = new.x.to(f64).cpu()
        seen["rounds"] += 1
        want, deficit = _deficit_by_hand(torch, snap, x_t, g_t, hp.gamma, n)
        reach = hp.gamma * float(deficit.abs().max())
        if reach > 0:
            seen["with_deficit"] += 1
            ulps = ASYNC_ULPS * 2.0 ** -24 * (
                x_t.abs() + hp.gamma * (g_t.abs() + deficit.abs()))
            bound = ASYNC_DEFICIT_LIMIT * reach + ulps
            worst["engine"] = max(worst["engine"], float(
                ((x_card - want).abs() / bound).max()))
            for plant in ("shift", "sign"):
                bad, _ = _deficit_by_hand(torch, snap, x_t, g_t, hp.gamma,
                                          n, plant)
                worst[plant] = max(worst[plant], float(
                    ((x_card - bad).abs() / bound).max()))
        return new, coin, vals

    sim._round_scatter = checked
    sim.run(sim.init(torch.zeros(d, device="cuda"), 1, device="cuda"),
            ASYNC_CHECK_ROUNDS)
    del sim._round_scatter
    tag = "[async-deficit]"
    if not (seen["rounds"] == ASYNC_CHECK_ROUNDS
            and seen["with_deficit"] > 0):
        raise AssertionError(f"{tag} rounds checked {seen}: want every "
                             "round, some with messages in flight")
    if not worst["engine"] <= 1.0:
        raise AssertionError(f"{tag} x_(t+1) against x_t - gamma (g_t - "
                             f"deficit_t) in float64: {worst['engine']:.3g}"
                             " of the bound")
    for plant in ("shift", "sign"):
        if not worst[plant] > 1.0:
            raise AssertionError(f"{tag} the planted fault {plant!r} "
                                 f"passed: {worst[plant]:.3g}")
    log(f"{tag} dasha tau={ASYNC_TAU} sigma={max(ASYNC_SIGMAS)} fused RandK "
        f"({n}, {m}, {d}), {seen['rounds']} rounds ({seen['with_deficit']} "
        f"with messages in flight): worst error {worst['engine']:.3g} of the "
        f"bound ({ASYNC_DEFICIT_LIMIT} gamma max|deficit| + {ASYNC_ULPS} "
        f"ulps); planted faults give shift {worst['shift']:.3g}, sign "
        f"{worst['sign']:.3g} | {smi}")
    return {"rounds": seen, "worst_in_units_of_the_bound": worst,
            "limit": ASYNC_DEFICIT_LIMIT, "ulps": ASYNC_ULPS}


def _async_heap_vec(torch, smi: str, problem):
    """Phase 16b, second part: heap == vec at the real-sim width, tau = 2,
    sigma = 2, ASYNC_EQ_ROUNDS rounds: dasha and marina with fused RandK
    (kernel 1), dasha with fused QDither s = 15 (kernel 2).  Every heap
    upload is verified and decoded to its message rows.  Gates: the
    integer traces (bytes, coins, participants) and bits equal, the clocks
    within 2e-5 and the metric within 1e-4 relative, the final x within
    1e-4 of its largest magnitude."""
    import numpy as np
    from repro_torch.bench import fed_async as fa
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FedSim, VecFedSim

    n, m, d = (int(v) for v in problem.features.shape)
    k, sub, _, L = fa.campaign_setup(problem, "fused", K_RANDK)[3:]
    comps = {"randk": make_round_compressor("randk", d, n, k=k,
                                            backend="fused", device="cuda"),
             "qdither": make_round_compressor("qdither", d, n, s=S_QDITHER,
                                              backend="fused",
                                              device="cuda")}
    campaigns = [("dasha", "randk"), ("marina", "randk"),
                 ("dasha", "qdither")]
    sigma, rounds = max(ASYNC_SIGMAS), ASYNC_EQ_ROUNDS

    def run(cls, variant, comp, r, watch=False):
        rc = comps[comp]
        hp = fa.bench_hyper(variant, rc.omega, L, d=d, k=k, n=n, m=m)
        sim = cls(variant, rc, sub, hp, compute_s=0.0, seed=fa.SEED,
                  tau=ASYNC_TAU, **fa.links(sigma))
        clock = _watch_heap(sim, r) if watch else None
        t0 = time.perf_counter()
        res = sim.run(sim.init(torch.zeros(d, device="cuda"), 1,
                               device="cuda"), r)
        torch.cuda.synchronize()
        if watch:
            _unwatch_heap(sim)
        return res, time.perf_counter() - t0, clock

    for variant, comp in campaigns:                  # warm-up, not counted
        for cls in (FedSim, VecFedSim):
            run(cls, variant, comp, 2)
    torch.cuda.synchronize()
    _reset_launch_counts()
    rows = []
    for variant, comp in campaigns:
        rh, hwall, clock = run(FedSim, variant, comp, rounds, watch=True)
        rv, vwall, _ = run(VecFedSim, variant, comp, rounds)
        cmp = fa.compare_heap_vec(rh, rv, fa.INT_TRACES)
        x_err = float((rv.state.x - rh.state.x).abs().max()
                      / rh.state.x.abs().max())
        tag = f"[async] heap vs vec {variant} {comp}"
        if not (cmp["integer_traces_bit_exact"] and np.array_equal(
                rh.traces["bits_sent"], rv.traces["bits_sent"])):
            bad = [t for t, ok in cmp["integer_traces"].items() if not ok]
            raise AssertionError(f"{tag}: integer traces differ: {bad}")
        if not (cmp["wall_clock_rel_err"] <= ASYNC_WALL_RTOL
                and cmp["metric_rel_err"] <= ASYNC_METRIC_RTOL
                and x_err <= ASYNC_X_RTOL):
            raise AssertionError(f"{tag}: clock rel err "
                                 f"{cmp['wall_clock_rel_err']}, metric "
                                 f"{cmp['metric_rel_err']}, x {x_err}")
        if clock["gated_rounds"] != rounds:
            raise AssertionError(f"{tag}: {clock['gated_rounds']} of "
                                 f"{rounds} rounds decoded")
        if variant == "marina" and not rh.summary["sync_rounds"] > 0:
            raise AssertionError(f"{tag}: no coin round")
        row = {"variant": variant, "compressor": comp, "rounds": rounds,
               "heap_rounds_per_s": rounds / hwall,
               "vec_rounds_per_s": rounds / vwall,
               "uploads_decoded": clock["gated_uploads"],
               "sync_rounds": rh.summary["sync_rounds"],
               "sim_wall_clock_s": rh.summary["wall_clock_s"],
               "wall_clock_rel_err": cmp["wall_clock_rel_err"],
               "metric_rel_err": cmp["metric_rel_err"], "x_rel_err": x_err,
               **_host_split(hwall, clock, rounds)}
        rows.append(row)
        log(f"{tag}: {rounds} rounds, heap {row['heap_rounds_per_s']:.1f} "
            f"rounds/s, vec {row['vec_rounds_per_s']:.1f} rounds/s; integer "
            f"traces equal, clock rel err {cmp['wall_clock_rel_err']:.3g}, "
            f"metric {cmp['metric_rel_err']:.3g}, x {x_err:.3g}; "
            f"{clock['gated_uploads']} uploads decoded | {smi}")
    counts = _launch_counts()
    _gate_launches("async", counts, {"dasha_sparsify_update": 2 * 2 * rounds,
                                     "quantize": 2 * rounds})
    return {"campaigns": rows, "launches": counts}, counts


def _async_scale(torch, smi: str, fed_peak_gb: float):
    """Phase 16c: phase 11's cross-device campaign (n = 100,000, C = 64, m =
    1, d = 20,958, fused RandK on the cohort, the slab store and kernel 4)
    at tau = 2 for ASYNC_SCALE_ROUNDS rounds, then with round barriers at
    the same configuration.  Gates: the async run's peak within phase 11's
    plus ASYNC_PEAK_SLACK_GB (an (n, d) deficit transient would be 8.4
    GB), launches (kernel 1 once a round, kernel 4 twice a chunk), 64
    participants and finite traces.  Then slab == scatter bit for bit at
    n = 10,000, 64 rounds, tau in {0, 2}."""
    import numpy as np
    from repro_torch.bench.fed_async import same_run
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification

    n, d, c, rounds = FED_N, D_REALSIM, FED_C, ASYNC_SCALE_ROUNDS
    gc.collect()
    torch.cuda.empty_cache()
    feats, labels = synthetic_classification(0, n, 1, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)

    def metric(s):
        return torch.sum(s.g ** 2)

    out, counts = {}, {}
    for mode, tau in (("async", ASYNC_TAU), ("barrier", None)):
        sim = _fed_sim(problem, n, d, c, hyper_kw=dict(L=L),
                       chunk=FED_CHUNK, tau=tau)
        state = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
        sim.run(state, 2, metric_fn=metric)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run(state, rounds, metric_fn=metric)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[mode] = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        tr = res.traces
        want = {"dasha_sparsify_update": rounds,
                "slab_writeback": 2 * -(-rounds // FED_CHUNK)}
        _gate_launches(f"async-scale {mode}", counts[mode], want)
        if not (np.all(tr["participants"] == c) and all(
                np.isfinite(tr[k]).all() for k in ("metric",
                                                   "sim_wall_clock"))):
            raise AssertionError(f"[async-scale] {mode}: participants or "
                                 "non-finite traces")
        out[mode] = {"rounds_per_s": rounds / wall, "wall_s": wall,
                     "peak_mem_gb": peak,
                     "sim_wall_clock_s": res.summary["wall_clock_s"],
                     "grad_sq_final": float(tr["metric"][-1]),
                     "launches": counts[mode]}
        del res, state, sim
        torch.cuda.empty_cache()
    limit = fed_peak_gb + ASYNC_PEAK_SLACK_GB
    if not out["async"]["peak_mem_gb"] <= limit:
        raise AssertionError(f"[async-scale] peak "
                             f"{out['async']['peak_mem_gb']:.2f} GB over "
                             f"phase 11's {fed_peak_gb:.2f} + "
                             f"{ASYNC_PEAK_SLACK_GB} GB")
    log(f"[async-scale] dasha fused RandK n={n} C={c} d={d}, {rounds} "
        f"rounds: async tau={ASYNC_TAU} {out['async']['rounds_per_s']:.1f} "
        f"rounds/s, peak {out['async']['peak_mem_gb']:.2f} GB (gate "
        f"{limit:.2f}); barrier {out['barrier']['rounds_per_s']:.1f} "
        f"rounds/s, peak {out['barrier']['peak_mem_gb']:.2f} GB; simulated "
        f"{out['async']['sim_wall_clock_s']:.2f} vs "
        f"{out['barrier']['sim_wall_clock_s']:.2f} s | {smi}")
    del problem, feats, labels
    torch.cuda.empty_cache()

    # slab == scatter at n = 10,000 on the card, tau in {0, 2}
    n2 = ASYNC_SS_N
    feats2, labels2 = synthetic_classification(1, n2, 1, d, device="cuda")
    prob2 = FiniteSumProblem(_glm_loss(torch), feats2, labels2)
    L2 = float((feats2.norm(dim=-1) ** 2).mean() * 2)
    for tau in (0, ASYNC_TAU):
        runs = {}
        for store in ("slab", "scatter"):
            sim = _fed_sim(prob2, n2, d, c, store=store,
                           hyper_kw=dict(L=L2), chunk=FED_CHUNK, tau=tau)
            state = sim.init(torch.zeros(d, device="cuda"), 3,
                             device="cuda")
            runs[store] = sim.run(state, ASYNC_SS_ROUNDS, metric_fn=metric)
            del state
        a, b = runs["slab"], runs["scatter"]
        if not same_run(a, b):
            raise AssertionError(f"[async-scale] slab vs scatter differ at "
                                 f"tau={tau}")
        del runs, a, b
    log(f"[async-scale] slab == scatter bit for bit on the card: n={n2} "
        f"C={c} d={d}, {ASYNC_SS_ROUNDS} rounds, tau in (0, {ASYNC_TAU})")
    del feats2, labels2, prob2
    torch.cuda.empty_cache()
    out["slab_equals_scatter"] = {"n": n2, "rounds": ASYNC_SS_ROUNDS,
                                  "taus": [0, ASYNC_TAU], "ok": True}
    return out, counts["async"]


def phase_async(torch, smi: str, fault_peak_gb=None, fed_peak_gb=None):
    """Phase 16: asynchronous pipelined rounds.  16a the severity and tau
    sweeps at the real-sim width with tau = 0 == barrier on the card, 16b
    the deficit arithmetic against float64 by hand (with two planted
    faults) and heap == vec with kernels 1 and 2, both under a peak gate
    of phase 15's peak plus the ring; 16c the cross-device slab campaign
    at tau = 2 under phase 11's peak plus 1 GB, and slab == scatter.
    Returns the report and the async path's launches of kernels 1, 2
    and 4."""
    from repro_torch.bench import fed_async as fa

    n, m, d = ASYNC_N, FAULT_M, D_REALSIM
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    problem = fa.make_problem(d, n, m, device="cuda")
    torch.cuda.synchronize()
    log(f"[async] cuts: {ASYNC_CUTS}")
    log(f"[async] real-sim-width data ({n}, {m}, {d}) = "
        f"{problem.features.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s; earlier phases hold "
        f"{base / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    sweep, sweep_counts = _async_sweep(torch, smi, problem)
    deficit = _async_deficit_check(torch, smi, problem)
    equiv, equiv_counts = _async_heap_vec(torch, smi, problem)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ring_gb = ASYNC_TAU * n * d * 4 / 1e9
    limit = (FAULT_PEAK_GB if fault_peak_gb is None else fault_peak_gb) \
        + ring_gb + ASYNC_PEAK_MARGIN_GB
    if peak > limit:
        raise AssertionError(f"[async] peak {peak:.2f} GB over {limit:.2f}"
                             f" GB (phase 15's peak, the ring and "
                             f"{ASYNC_PEAK_MARGIN_GB} GB)")
    log(f"[async] peak {peak:.2f} GB with all that the card holds (gate "
        f"{limit:.2f} GB: phase 15's peak + the {ring_gb * 1e3:.1f} MB ring "
        f"+ {ASYNC_PEAK_MARGIN_GB} GB) | {smi}")
    del problem
    torch.cuda.empty_cache()
    scale, scale_counts = _async_scale(
        torch, smi, FED_PEAK_GB if fed_peak_gb is None else fed_peak_gb)
    launches = {"dasha_sparsify_update": sweep_counts["dasha_sparsify_update"]
                + equiv_counts["dasha_sparsify_update"]
                + scale_counts["dasha_sparsify_update"],
                "quantize": equiv_counts["quantize"],
                "slab_writeback": scale_counts["slab_writeback"]}
    return {"n": n, "m": m, "d": d, "K": K_RANDK, "tau": ASYNC_TAU,
            "features_gb": n * m * d * 4 / 1e9,
            "held_by_earlier_phases_gb": base / 1e9, "peak_mem_gb": peak,
            "peak_gate_gb": limit,
            "links": {"up_Bps": fa.UP_BW, "down_Bps": fa.DOWN_BW,
                      "latency_s": fa.LATENCY, "compute_s": 0.0,
                      "net_seed": fa.SEED},
            "cuts": ASYNC_CUTS, "sweep": sweep, "deficit_by_hand": deficit,
            "heap_vs_vec": equiv, "scale": scale, "launches": launches,
            "nvidia_smi": smi}, launches


def _obs_sim_events(tl):
    """A timeline's simulated-time events (client and server tracks)."""
    from repro_torch.obs import COMPILER, HOST
    return [e for e in tl.events if e.track not in (HOST, COMPILER)]


def _obs_timeline_problems(tl, res, fc=None):
    """Phase 17a's checks on one live heap timeline, as problem strings
    (none: it passes): the schema, the per-round byte sums against the
    traced ``bytes_up`` / ``bytes_down``, every round and every sync round
    blamed once, and on a faulted campaign each kind of fault instant
    counted as the campaign's traces (``lost``, ``late``, ``rejoins``) or
    its fault draw (``crash_start``, ``drop_down``) count it."""
    import numpy as np
    from repro_torch.obs import attribute
    tr = res.traces
    rounds = len(tr["bytes_up"])
    probs = list(tl.validate())
    sums = tl.round_byte_sums()
    if not (np.array_equal(sums["round"], np.arange(rounds))
            and np.array_equal(sums["bytes_up"],
                               tr["bytes_up"].astype(np.int64))
            and np.array_equal(sums["bytes_down"],
                               tr["bytes_down"].astype(np.int64))):
        bad = np.flatnonzero(sums["bytes_up"] != tr["bytes_up"]) \
            if len(sums["bytes_up"]) == rounds else "all"
        probs.append(f"round byte sums differ from the traced bytes "
                     f"(up at rounds {bad})")
    at = attribute(tl)
    blamed = sum(c.blamed for c in at.clients.values())
    blamed_sync = sum(c.blamed_sync for c in at.clients.values())
    empty = at.critical_path.count(-1)      # rounds nobody uploaded in
    if not (at.rounds == blamed + empty == rounds
            and blamed_sync == at.sync_rounds
            == int(tr["sync_round"].sum())):
        probs.append(f"attribution: {at.rounds} rounds, {blamed} blamed "
                     f"and {empty} empty, {blamed_sync} blamed at "
                     f"{at.sync_rounds} sync rounds of "
                     f"{int(tr['sync_round'].sum())}")
    if fc is not None:
        names = ("crash", "drop_down", "drop_up", "deadline_cut", "rejoin")
        marks = {k: 0 for k in names}
        for e in tl.events:
            if e.kind == "instant" and e.name in marks:
                marks[e.name] += 1
        want = {"crash": int(fc.crash_start[:rounds].sum()),
                "drop_down": int(fc.drop_down[:rounds].sum()),
                "drop_up": int(tr["lost"].sum()),
                "deadline_cut": int(tr["late"].sum()),
                "rejoin": int(tr["rejoins"].sum())}
        if marks != want:
            probs.append(f"fault marks {marks}, the campaign's {want}")
    return probs


def _obs_events_differ(want_tl, got_tl):
    """The first difference between two timelines' simulated-time events
    (tracks, names, kinds, args, float64 timestamps bit for bit), or
    None."""
    want, got = _obs_sim_events(want_tl), _obs_sim_events(got_tl)
    if len(want) != len(got):
        return f"{len(got)} events, not {len(want)}"
    for i, (a, b) in enumerate(zip(want, got)):
        if (a.track, a.name, a.kind, a.t0, a.t1, a.args or {}) != \
                (b.track, b.name, b.kind, b.t0, b.t1, b.args or {}):
            return f"event {i}: {b} against {a}"
    return None


def _obs_heap(torch, smi: str, problem, out_dir):
    """Phase 17a: the heap oracle at the real-sim width with ``Obs.full()``
    attached, each campaign run plain and then with the handle, in turn:
    dasha and marina (p = 0.15) with round barriers, dasha at tau = 2, a
    faulted dasha (FM_MIXED), OBS_HEAP_ROUNDS rounds each, and a fused
    QDither dasha over OBS_QDITHER_ROUNDS (kernel 2); fused RandK K = 100
    (kernel 1), the async bench's links at sigma = 1.  Gates: each
    handle's run equal to the plain one bit for bit with no kernel build,
    the launches of both arms equal, and :func:`_obs_timeline_problems`
    empty on every timeline; two planted faults (an ``up`` span's bytes
    plus one, a fault instant removed) must fail those checks.  Each
    timeline is written as a Perfetto file into ``out_dir``."""
    from repro_torch.bench import fed_async as fa
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FaultModel, FedSim
    from repro_torch.obs import Obs, attribute, merge

    n, m, d = (int(v) for v in problem.features.shape)
    k, sub, rc, L = fa.campaign_setup(problem, "fused", K_RANDK)[3:]
    comps = {"randk": rc,
             "qdither": make_round_compressor("qdither", d, n, s=S_QDITHER,
                                              backend="fused",
                                              device="cuda")}
    fm = FaultModel(**ff.EQUIV_FAULTS["dasha"])
    campaigns = [("dasha", "dasha", "randk", {}, OBS_HEAP_ROUNDS),
                 ("marina", "marina", "randk", {}, OBS_HEAP_ROUNDS),
                 ("dasha_tau2", "dasha", "randk", {"tau": ASYNC_TAU},
                  OBS_HEAP_ROUNDS),
                 ("dasha_faulted", "dasha", "randk", {"faults": fm},
                  OBS_HEAP_ROUNDS),
                 ("dasha_qdither", "dasha", "qdither", {},
                  OBS_QDITHER_ROUNDS)]

    def sim_of(variant, comp, kw):
        c = comps[comp]
        hp = fa.bench_hyper(variant, c.omega, L, d=d, k=k, n=n, m=m)
        return FedSim(variant, c, sub, hp, compute_s=0.0, seed=fa.SEED,
                      **fa.links(OBS_SIGMA), **kw)

    def run(sim, rounds, obs=None):
        st = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run(st, rounds, obs=obs)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, _launch_counts()

    for _, variant, comp, kw, _ in campaigns:          # warm-up
        run(sim_of(variant, comp, kw), 2)
    arms = {"plain": {}, "obs": {}}
    rows, timelines, results = {}, {}, {}
    for label, variant, comp, kw, rounds in campaigns:
        sim = sim_of(variant, comp, kw)
        plain, pwall, pc = run(sim, rounds)
        obs = Obs.full(label=f"{label} n={n} d={d}")
        res, owall, oc = run(sim, rounds, obs)
        for arm, counts in (("plain", pc), ("obs", oc)):
            for name, v in counts.items():
                arms[arm][name] = arms[arm].get(name, 0) + v
        if not ff.same_run(plain, res):
            raise AssertionError(f"[obs] {label}: the run with the handle "
                                 "differs from the plain run")
        builds = obs.metrics.counter("compiles").value
        if builds:
            raise AssertionError(f"[obs] {label}: {builds} kernel builds "
                                 "with the handle attached")
        tl = obs.timeline
        fc = fm.draw_campaign(rounds, n) if "faults" in kw else None
        probs = _obs_timeline_problems(tl, res, fc)
        if probs:
            raise AssertionError(f"[obs] {label}: {probs}")
        doc = tl.to_perfetto(str(out_dir / f"obs_{label}.json"))
        at = attribute(tl)
        sync_s = sum(e.t1 - e.t0 for e in tl.events
                     if e.name == "sync_round")
        blamed_sync = sum(c.blamed_sync for c in at.clients.values())
        rows[label] = {
            "variant": variant, "compressor": comp, "rounds": rounds,
            "tau": kw.get("tau"), "faulted": "faults" in kw,
            "plain_rounds_per_s": rounds / pwall,
            "obs_rounds_per_s": rounds / owall,
            "obs_host_ms_per_round": (owall - pwall) / rounds * 1e3,
            "timeline_events": len(tl.events),
            "perfetto_events": len(doc["traceEvents"]),
            "sim_wall_clock_s": res.summary["wall_clock_s"],
            "barrier_s": at.barrier_s, "sync_rounds": at.sync_rounds,
            "sync_barrier_share": sync_s / at.barrier_s,
            "sync_blame_share": blamed_sync / at.rounds,
            "distinct_critical_clients": len(set(at.critical_path)),
            "launches_plain": pc, "launches_obs": oc}
        timelines[label], results[label] = tl, res
        log(f"[obs] heap {label}: {rounds} rounds, plain "
            f"{rows[label]['plain_rounds_per_s']:.1f} rounds/s, Obs.full() "
            f"{rows[label]['obs_rounds_per_s']:.1f} rounds/s; "
            f"{len(tl.events)} events, {len(doc['traceEvents'])} in "
            f"obs_{label}.json; barrier {at.barrier_s:.4f} s, "
            f"{at.sync_rounds} sync rounds ({sync_s:.4f} s, blame share "
            f"{rows[label]['sync_blame_share']:.3f}); bytes reconcile | "
            f"{smi}")
    if arms["plain"] != arms["obs"]:
        raise AssertionError(f"[obs] launches differ: plain "
                             f"{arms['plain']}, obs {arms['obs']}")
    want = {"dasha_sparsify_update": sum(r for _, _, c, _, r in campaigns
                                if c == "randk"),
            "quantize": OBS_QDITHER_ROUNDS}
    _gate_launches("obs heap", arms["obs"], want)

    # planted faults: each must fail the checks
    planted = {}
    bad = merge([timelines["dasha"]], "planted")
    i = next(j for j, e in enumerate(bad.events) if e.name == "up")
    e = bad.events[i]
    bad.events[i] = e._replace(args={**e.args, "bytes": e.args["bytes"] + 1})
    planted["up_bytes_plus_one"] = _obs_timeline_problems(
        bad, results["dasha"])
    bad = merge([timelines["dasha_faulted"]], "planted")
    i = next(j for j, e in enumerate(bad.events)
             if e.kind == "instant" and e.name in ("drop_up", "crash"))
    del bad.events[i]
    planted["fault_instant_removed"] = _obs_timeline_problems(
        bad, results["dasha_faulted"],
        fm.draw_campaign(OBS_HEAP_ROUNDS, n))
    missed = [p for p, probs in planted.items() if not probs]
    if missed:
        raise AssertionError(f"[obs] planted faults passed: {missed}")
    log(f"[obs] planted faults fail as they must: "
        f"{ {p: v[0][:90] for p, v in planted.items()} }")
    d_at, m_at = rows["dasha"], rows["marina"]
    log(f"[obs] barrier seconds: MARINA {m_at['barrier_s']:.4f} "
        f"({m_at['sync_rounds']} sync rounds, {m_at['sync_barrier_share']:.3f}"
        f" of its barrier time, blame share {m_at['sync_blame_share']:.3f})"
        f" vs DASHA {d_at['barrier_s']:.4f} ({d_at['sync_rounds']} sync "
        f"rounds); launches {arms['obs']} in each arm")
    return {"campaigns": rows, "launches": arms,
            "planted": {p: v[:2] for p, v in planted.items()},
            "sigma": OBS_SIGMA}, timelines, arms["obs"]


def _obs_vec(torch, smi: str, problem, heap_timelines):
    """Phase 17b: the barrier dasha and marina campaigns of 17a through
    VecFedSim (``Obs.full()`` attached: chunk spans), their per-client
    timelines rebuilt by ``reconstruct_vec_timeline`` and held event for
    event against 17a's live heap timelines (tracks, names, kinds, args,
    float64 timestamps bit for bit).  Planted faults (one timestamp moved
    by one ulp, one event dropped) must fail that check."""
    import numpy as np
    from repro_torch.bench import fed_async as fa
    from repro_torch.fed import VecFedSim
    from repro_torch.obs import Obs, merge, reconstruct_vec_timeline

    n, m, d = (int(v) for v in problem.features.shape)
    k, sub, rc, L = fa.campaign_setup(problem, "fused", K_RANDK)[3:]
    out, counts = {}, {}
    for variant in ("dasha", "marina"):
        hp = fa.bench_hyper(variant, rc.omega, L, d=d, k=k, n=n, m=m)
        sim = VecFedSim(variant, rc, sub, hp, compute_s=0.0, seed=fa.SEED,
                        **fa.links(OBS_SIGMA))
        st = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
        sim.run(st, 2)                                  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        obs = Obs.full(label=f"vec {variant}")
        t0 = time.perf_counter()
        res = sim.run(st, OBS_HEAP_ROUNDS, obs=obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, v in _launch_counts().items():
            counts[name] = counts.get(name, 0) + v
        t1 = time.perf_counter()
        tl = reconstruct_vec_timeline(sim, st, res)
        rebuild_s = time.perf_counter() - t1
        diff = _obs_events_differ(heap_timelines[variant], tl)
        if diff is not None:
            raise AssertionError(f"[obs] vec {variant}: {diff}")
        chunks = sum(e.name == "chunk" for e in obs.timeline.events)
        planted = {}
        bad = merge([tl], "planted")
        i = len(bad.events) // 2
        e = bad.events[i]
        bad.events[i] = e._replace(t0=float(np.nextafter(e.t0, np.inf)))
        planted["one_ulp"] = _obs_events_differ(heap_timelines[variant], bad)
        bad = merge([tl], "planted")
        del bad.events[i]
        planted["event_dropped"] = _obs_events_differ(
            heap_timelines[variant], bad)
        if not all(planted.values()):
            raise AssertionError(f"[obs] vec {variant}: a planted fault "
                                 f"passed: {planted}")
        out[variant] = {"rounds": OBS_HEAP_ROUNDS,
                        "rounds_per_s": OBS_HEAP_ROUNDS / wall,
                        "events": len(tl.events), "chunk_spans": chunks,
                        "rebuild_s": rebuild_s,
                        "planted": {p: v[:120] for p, v in planted.items()}}
        log(f"[obs] vec {variant}: {OBS_HEAP_ROUNDS} rounds at "
            f"{out[variant]['rounds_per_s']:.1f} rounds/s, {chunks} chunk "
            f"spans; rebuilt {len(tl.events)} events in {rebuild_s:.3f} s, "
            f"equal to the heap's event for event (timestamps bit for "
            f"bit); planted faults fail: {list(planted)} | {smi}")
    _gate_launches("obs vec", counts, {"dasha_sparsify_update": 2 * OBS_HEAP_ROUNDS})
    out["launches"] = counts
    return out, counts


def _obs_launches_profiled(torch, fn):
    """The device records (kernels, copies, sets) of ``fn`` by name, from
    a profiled window that two marker spin kernels bracket on the stream:
    only a record that starts after the opening marker ends and before the
    closing one starts is counted.  The warm-up before the opening marker
    issues each kind of record a campaign chunk does (kernels, and copies
    to and from the card), since the profiler can lose the first records
    of a kind in a window.  It can lose records all the same, never add
    any: the caller takes the most of several windows.  Only the card's
    records are taken (a third of the time of a window with the host's
    too)."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    probe = torch.arange(8, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            torch.cuda._sleep(1000)
            probe.to("cuda").to(torch.float64).cpu()
        torch.cuda.synchronize()
        time.sleep(PROFILE_WARMUP_S)
        torch.cuda._sleep(1000)                          # opening marker
        fn()
        torch.cuda._sleep(1000)                          # closing marker
        torch.cuda.synchronize()
    # the profiler's raw device records (name, start, end in ns), not its
    # event tree, which takes seconds to build for a window of ~10^4
    records = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    marks = sorted((start, end) for name, start, end in records
                   if "spin_kernel" in name)
    if len(marks) < 2:
        return Counter()
    lo, hi = marks[-2][1], marks[-1][0]
    return Counter(name for name, start, _ in records
                   if "spin_kernel" not in name and lo <= start < hi)


def _obs_overhead(torch, smi: str):
    """Phase 17c: fed_scale_bench's obs gate (n = 10,000, C = 64) at
    real-sim's width: phase 12b's sampled VecFedSim, m = 1, fused RandK
    K = 100 (kernel 1), the slab store (kernel 4), in campaigns of one
    chunk of OBS_GATE_ROUNDS rounds.  One warm-up chunk and three plain campaigns that size the
    planted handle, then a plain campaign and OBS_TURNS turns of
    OBS_TURN (three runs with the handle
    ``Obs.metrics_only(MemorySink())`` and one planted, each followed by
    a plain run), the objects the earlier phases left frozen out of the
    collector's way and a collection before every run, outside its time.
    Each handle run and each planted run is read against the mean of the
    two plain runs around it; each inner plain run against its two plain
    neighbours is the control.  Gates: the median of the handle's ratios
    within OBS_OVERHEAD, and the median of the planted handle's (it spins
    on the host for OBS_PLANTED times the gate of a plain campaign's
    wall) at or over it (the reference's best-of fractions are
    reported); no kernel build with the handle; every run's final state
    and traces bit-identical; kernels 1 and 4 launched equally in every
    run; one profiled chunk launching as many CUDA kernels with the
    handle as without, name for name, each arm the most of
    OBS_PROFILE_WINDOWS windows; the handle's peak within
    OBS_PEAK_SLACK_GB of the plain runs'.  Then phase 11's n = 100,000
    campaign over OBS_SCALE_ROUNDS rounds with and without the handle,
    reported without a gate.  Returns the report and one run's
    launches."""
    from repro_torch.bench.fed_faults import same_run
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.obs import MemorySink, Obs

    n, d, c, rounds = HEAP_N, D_REALSIM, FED_C, OBS_GATE_ROUNDS
    gc.collect()
    torch.cuda.empty_cache()
    feats, labels = synthetic_classification(1, n, 1, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)

    def metric(s):
        return torch.sum(s.g ** 2)

    sim = _fed_sim(problem, n, d, c, hyper_kw=dict(L=L), chunk=FED_CHUNK)
    state = sim.init(torch.zeros(d, device="cuda"), 3, device="cuda")
    sim.run(state, FED_CHUNK, metric_fn=metric)          # warm-up
    torch.cuda.synchronize()

    def one(obs):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run(state, rounds, metric_fn=metric, obs=obs)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9, _launch_counts())

    # the planted fault: a handle that spins on the host each time a run
    # loop asks it for a histogram, OBS_PLANTED times the gate of a plain
    # campaign's wall in all
    spin = {"s": 0.0, "calls": 0}

    def planted():
        obs = Obs.metrics_only(MemorySink())
        real = obs.histogram

        def histogram(name):
            spin["calls"] += 1
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < spin["s"]:
                pass
            return real(name)

        obs.histogram = histogram
        return obs

    plain_s = statistics.median(one(None)[1] for _ in range(3))
    one(planted())
    spin["s"] = OBS_PLANTED * OBS_OVERHEAD * plain_s / max(spin["calls"], 1)

    handles = {"plain": lambda: None,
               "obs": lambda: Obs.metrics_only(MemorySink()),
               "planted": planted}
    seq = ["plain"] + OBS_TURNS * list(OBS_TURN)
    walls, peaks = [], {arm: [] for arm in handles}
    first = None
    # the earlier phases' objects out of the collector's way: a full
    # collection over them inside one run and not the next would weigh
    # as much as the gate
    gc.collect()
    gc.freeze()
    for arm in seq:
        obs = handles[arm]()
        res, wall, peak, counts = one(obs)
        walls.append(wall)
        peaks[arm].append(peak)
        if first is None:
            first = (res, counts)
        elif not same_run(first[0], res) or counts != first[1]:
            raise AssertionError(f"[obs] overhead {arm}: the run or its "
                                 f"launches {counts} differ from the "
                                 f"first run's {first[1]}")
        if obs is not None:
            builds = obs.metrics.counter("compiles").value
            fed_rounds = obs.metrics.counter("fed.rounds").value
            if builds or fed_rounds != rounds:
                raise AssertionError(f"[obs] overhead: {builds} builds, "
                                     f"{fed_rounds} rounds counted")
        del res
    gc.unfreeze()
    want = {"dasha_sparsify_update": rounds,
            "slab_writeback": 2 * -(-rounds // FED_CHUNK)}
    _gate_launches("obs overhead", first[1], want)

    # each run against the plain runs on either side: the host drifts
    # from one run to the next by as much as the gate, and the mean of
    # the two neighbours cancels a drift that is steady over the three
    def bracketed(arm, gap=1):
        return [walls[i] / (0.5 * (walls[i - gap] + walls[i + gap])) - 1.0
                for i in range(gap, len(seq) - gap) if seq[i] == arm]

    ratios = {"obs": bracketed("obs"), "planted": bracketed("planted"),
              "control": bracketed("plain", gap=2)}
    frac, planted_frac, control = (statistics.median(ratios[a]) for a in
                                   ("obs", "planted", "control"))
    by_arm = {arm: [w for w, a in zip(walls, seq) if a == arm]
              for arm in handles}
    best = {arm: min(w) for arm, w in by_arm.items()}
    best_frac = best["obs"] / best["plain"] - 1.0
    peak_gap = max(peaks["obs"]) - max(peaks["plain"])
    obs_host_ms = statistics.median(
        walls[i] - 0.5 * (walls[i - 1] + walls[i + 1])
        for i in range(1, len(seq) - 1) if seq[i] == "obs") / rounds * 1e3

    # one profiled chunk with and without the handle: equal launches,
    # name for name.  The profiler loses records now and then (on the
    # H100 a window of this chunk read 7 of its 10,909 records short) and
    # never adds any, so each arm's count is the most of
    # OBS_PROFILE_WINDOWS windows, the arms in turn, and a short window is
    # logged with what it missed.
    arms = {"plain": lambda: sim.run(state, FED_CHUNK, metric_fn=metric),
            "obs": lambda: sim.run(state, FED_CHUNK, metric_fn=metric,
                                   obs=Obs.metrics_only(MemorySink()))}
    windows = {arm: [] for arm in arms}
    for _ in range(OBS_PROFILE_WINDOWS):
        for arm, fn in arms.items():
            windows[arm].append(_obs_launches_profiled(torch, fn))
    most = {arm: functools.reduce(operator.or_, ws)
            for arm, ws in windows.items()}
    launches = {arm: sum(t.values()) for arm, t in most.items()}
    window_counts = {arm: [sum(t.values()) for t in ws]
                     for arm, ws in windows.items()}
    for arm, ws in windows.items():
        for i, t in enumerate(ws):
            if t != most[arm]:
                log(f"[obs] profiled chunk, {arm} window {i + 1}: "
                    f"{sum(t.values())} records, short of "
                    f"{dict(most[arm] - t)}")
    diff = {k: (most["plain"][k], most["obs"][k])
            for k in most["plain"].keys() | most["obs"].keys()
            if most["plain"][k] != most["obs"][k]}
    out = {"n": n, "c": c, "d": d, "rounds": rounds, "turns": OBS_TURNS,
           "sequence": seq, "walls_s": walls, "ratios": ratios,
           "best_s": best, "overhead_frac": frac,
           "planted_frac": planted_frac, "planted_spin_s": spin["s"],
           "control_frac": control, "best_of_overhead_frac": best_frac,
           "peak_gb": peaks, "peak_gap_gb": peak_gap, "launches": first[1],
           "profiled_chunk_launches": launches,
           "profiled_window_launches": window_counts,
           "obs_host_ms_per_round": obs_host_ms,
           "ratio_sd": {a: statistics.pstdev(r) for a, r in ratios.items()}}
    # the runs on disk before the gates, so that a failed gate can be read
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "obs_overhead.json").write_text(json.dumps(out, indent=1))
    log(f"[obs] overhead n={n} C={c} d={d}, campaigns of {rounds} rounds, "
        f"{len(ratios['obs'])} handle runs each against the plain runs on "
        f"either side (one ratio's sd {out['ratio_sd']['obs'] * 100:.2f}%):"
        f" median {frac * 100:+.2f}% (gate < "
        f"{OBS_OVERHEAD * 100:.0f}%), plain against its plain neighbours "
        f"{control * 100:+.2f}% (control), the planted handle "
        f"({spin['s'] * 1e3:.3f} ms of spin a call, {OBS_PLANTED:g} x the "
        f"gate) {planted_frac * 100:+.2f}% over {len(ratios['planted'])} "
        f"runs; best of each arm: plain {best['plain']:.4f} s, "
        f"Obs.metrics_only {best['obs']:.4f} s ({best_frac * 100:+.2f}%); "
        f"peaks plain {max(peaks['plain']):.4f} GB, obs "
        f"{max(peaks['obs']):.4f} GB; profiled chunk launches {launches} "
        f"(most of the windows {window_counts}); kernel launches a run "
        f"{first[1]} | {smi}")
    if abs(control) >= OBS_OVERHEAD:
        log(f"[obs] the plain-against-plain control reads "
            f"{control * 100:+.2f}%: the host spreads by more than the gate")
    if not frac < OBS_OVERHEAD:
        raise AssertionError(f"[obs] overhead {frac * 100:.2f}% not under "
                             f"{OBS_OVERHEAD * 100:.0f}% (control "
                             f"{control * 100:+.2f}%)")
    if not planted_frac >= OBS_OVERHEAD:
        raise AssertionError(f"[obs] the planted handle, {OBS_PLANTED:g} x "
                             f"the gate, reads {planted_frac * 100:+.2f}%: "
                             f"the gate cannot see it")
    if not abs(peak_gap) <= OBS_PEAK_SLACK_GB:
        raise AssertionError(f"[obs] peak with the handle {peak_gap:+.4f} GB"
                             f" from the plain run's")
    if diff or launches["plain"] == 0:
        raise AssertionError(f"[obs] profiled chunk launches {launches}, "
                             f"differing (plain, obs) by name {diff}")
    per_run = first[1]
    del sim, state, problem, feats, labels, first
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11's n = 100,000 campaign with and without the handle
    n2, r2 = FED_N, OBS_SCALE_ROUNDS
    feats, labels = synthetic_classification(0, n2, 1, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)
    sim = _fed_sim(problem, n2, d, c, hyper_kw=dict(L=L), chunk=FED_CHUNK)
    state = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
    sim.run(state, 2, metric_fn=metric)                 # warm-up
    scale = {}
    for arm in ("plain", "obs", "plain_again"):
        obs = Obs.metrics_only(MemorySink()) if arm == "obs" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(state, r2, metric_fn=metric, obs=obs)
        torch.cuda.synchronize()
        scale[arm] = r2 / (time.perf_counter() - t0)
    out["scale"] = {"n": n2, "rounds": r2, "rounds_per_s": scale}
    log(f"[obs] n={n2} C={c} d={d}, {r2} rounds: plain "
        f"{scale['plain']:.1f}, Obs.metrics_only {scale['obs']:.1f}, plain "
        f"again {scale['plain_again']:.1f} rounds/s (no gate) | {smi}")
    del sim, state, problem, feats, labels
    torch.cuda.empty_cache()
    return out, per_run


def _obs_build_spans():
    """Phase 17d: the build phase inside ``Obs.full().compile_spans()``
    records one ``backend_compile`` span (and one ``compiles`` count) for
    each library whose ``.so`` was missing before it: none on the warm
    cache phase 1 left.  Then the same into an empty build directory under
    ``build/``, where every source is built again and each must be
    recorded."""
    import shutil
    from repro_torch.kernels import build
    from repro_torch.obs import COMPILER, Obs

    def spans_of(label):
        missing = sorted(s for s in build.sources()
                         if not build.library_path(s).exists())
        obs = Obs.full(label=label)
        t0 = time.perf_counter()
        with obs.compile_spans():
            phase_build()
        wall = time.perf_counter() - t0
        spans = [e for e in obs.timeline.events
                 if e.track == COMPILER and e.name == "backend_compile"]
        got = sorted(e.args["kernel"] for e in spans)
        if got != missing or obs.metrics.counter("compiles").value != \
                len(missing):
            raise AssertionError(f"[obs] {label}: build spans {got}, "
                                 f"missing libraries {missing}")
        return {"missing_before": missing, "spans": len(spans),
                "span_s": {e.args["kernel"]: e.args["duration_s"]
                           for e in spans}, "wall_s": wall}

    out = {"warm": spans_of("warm cache")}
    cold_dir = build.BUILD_DIR.parent / "kernels_obs_check"
    shutil.rmtree(cold_dir, ignore_errors=True)
    saved = build.BUILD_DIR
    build.BUILD_DIR = cold_dir
    try:
        out["cold"] = spans_of("cold cache")
    finally:
        build.BUILD_DIR = saved
        shutil.rmtree(cold_dir, ignore_errors=True)
    log(f"[obs] build spans: warm cache {out['warm']['spans']} (libraries "
        f"missing before: {out['warm']['missing_before']}); an empty build "
        f"directory {out['cold']['spans']} spans for "
        f"{out['cold']['missing_before']}, seconds {out['cold']['span_s']}")
    return out


def phase_obs(torch, smi: str):
    """Phase 17: campaign telemetry (``repro_torch.obs``).  17a the heap
    oracle with ``Obs.full()`` at the real-sim width, 17b vec replay equal
    to the heap, 17c the handle's cost and invariance at n = 10,000 (and
    n = 100,000 reported), 17d the build spans.  Returns the report and
    the launches of kernels 1, 2 and 4 in the runs with a handle."""
    from repro_torch.bench import fed_async as fa

    n, m, d = ASYNC_N, FAULT_M, D_REALSIM
    t_phase = time.perf_counter()
    log(f"[obs] cuts: {OBS_CUTS}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    problem = fa.make_problem(d, n, m, device="cuda")
    heap, timelines, heap_counts = _obs_heap(torch, smi, problem, out_dir)
    vec, vec_counts = _obs_vec(torch, smi, problem, timelines)
    del problem, timelines
    overhead, over_counts = _obs_overhead(torch, smi)
    handle_runs = OBS_TURNS * OBS_TURN.count("obs")
    builds = _obs_build_spans()
    launches = {"dasha_sparsify_update": heap_counts["dasha_sparsify_update"]
                + vec_counts["dasha_sparsify_update"]
                + handle_runs * over_counts["dasha_sparsify_update"],
                "quantize": heap_counts["quantize"],
                "slab_writeback": handle_runs
                * over_counts["slab_writeback"]}
    wall = time.perf_counter() - t_phase
    log(f"[obs] phase 17 in {wall:.1f} s; launches with a handle "
        f"{launches} | {smi}")
    return {"n": n, "m": m, "d": d, "K": K_RANDK, "cuts": OBS_CUTS,
            "heap": heap, "vec_replay": vec, "overhead": overhead,
            "build_spans": builds, "launches": launches, "wall_s": wall,
            "nvidia_smi": smi}, launches


# ---------------------------------------------------------------------------
# phase 18: full-state checkpoints, kill and restore through files
# ---------------------------------------------------------------------------

def _state_parts(torch, state, prefix=""):
    """(tensor leaves, host leaves) of a state as {path: value}."""
    tensors, host = {}, {}
    if isinstance(state, torch.Tensor):
        tensors[prefix] = state
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        for f in state._fields:
            t, h = _state_parts(torch, getattr(state, f), f"{prefix}{f}/")
            tensors.update(t)
            host.update(h)
    elif isinstance(state, dict):
        for k in sorted(state):
            t, h = _state_parts(torch, state[k], f"{prefix}{k}/")
            tensors.update(t)
            host.update(h)
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            t, h = _state_parts(torch, v, f"{prefix}{i}/")
            tensors.update(t)
            host.update(h)
    elif state is not None:
        host[prefix] = state
    return tensors, host


def _stored_nbytes(torch, state) -> int:
    """The bytes a checkpoint of ``state`` holds (bfloat16 widened to
    float32; a host leaf 8 bytes at most)."""
    tensors, host = _state_parts(torch, state)
    return sum(t.numel() * (4 if t.dtype == torch.bfloat16
                            else t.element_size())
               for t in tensors.values()) + 8 * len(host)


def _ckpt_diff(torch, got, want):
    """(bit-equal, worst tensor-leaf error as a fraction of the leaf's
    largest magnitude, that leaf) between two states; a host leaf that
    differs, or a different structure, counts as infinitely far."""
    import numpy as np
    gt, gh = _state_parts(torch, got)
    wt, wh = _state_parts(torch, want)
    if sorted(gt) != sorted(wt) or sorted(gh) != sorted(wh):
        return False, math.inf, "structure"
    for k in wh:
        if not np.array_equal(np.asarray(gh[k]), np.asarray(wh[k])):
            return False, math.inf, k
    equal, worst, where = True, 0.0, None
    for k, w in wt.items():
        g = gt[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, math.inf, k
        if torch.equal(g, w):
            continue
        equal = False
        wf, gf = w.float(), g.float()
        scale = max(float(wf.abs().max()), 1e-30)
        err = float((gf - wf).abs().max()) / scale
        if not err <= worst:
            worst, where = err, k
    return equal, worst, where


def _one_ulp_row(torch, state, row: int, by=None):
    """``state`` with h_local's row ``row`` moved one ulp up (a tree's
    every leaf's node row, a flat store's row), or by ``by`` times the
    leaf's largest magnitude."""
    def bump(t):
        t = t.clone()
        if by is None:
            t[row] = torch.nextafter(t[row],
                                     torch.full_like(t[row], math.inf))
        else:
            t[row] += by * t.abs().max()
        return t

    h = state.h_local
    if isinstance(h, dict):
        from repro_torch.core import tree
        return state._replace(h_local=tree.map_leaves(bump, h))
    return state._replace(h_local=bump(h))


def _check_disk(directory: str, nbytes: int) -> float:
    """Free bytes under ``directory``; fails below twice ``nbytes``."""
    free = shutil.disk_usage(directory).free
    if free < 2 * nbytes:
        raise AssertionError(f"[ckpt] {free / 1e9:.2f} GB free under "
                             f"{directory}, less than twice the "
                             f"{nbytes / 1e9:.2f} GB file")
    return free


def _file_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _drill_mismatch(torch, full, res, cut: int):
    """What differs between an uninterrupted campaign's tail (rounds
    ``cut``..) and a resumed one: trace names, and the final state."""
    import numpy as np
    bad = sorted(set(full.traces) ^ set(res.traces))
    bad += [k for k in full.traces if k in res.traces
            and not np.array_equal(full.traces[k][cut:], res.traces[k])]
    equal, _, where = _ckpt_diff(torch, res.state, full.state)
    if not equal:
        bad.append(f"state:{where}")
    return bad


def _ckpt_trainer(torch, smi: str, tmp: str):
    """18a: the trainer's --ckpt / --resume at full width (depth cut)."""
    from repro_torch.checkpoint import checkpoint_step, load_method_state
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config("mamba2-780m"),
                              num_layers=CKPT_LAYERS)
    path = os.path.join(tmp, "trainer")
    base = ["--log-every", str(CKPT_CUT), "--variant", "mvr",
            "--use-kernel"]

    chunk_peaks = []

    def arm(steps, *extra):
        res = train(cfg, _train_args(["--steps", str(steps), *base,
                                      *extra]), device="cuda", log=log)
        chunk_peaks.extend(c["peak_mem_gb"] for c in res.chunks)
        return res

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t_drill = time.perf_counter()
    full = arm(CKPT_STEPS).state                       # arm 1
    control = arm(CKPT_STEPS).state                    # arm 1 again
    ctrl_equal, ctrl_err, ctrl_leaf = _ckpt_diff(torch, control, full)
    del control
    if ctrl_equal:
        log("[ckpt] trainer control pair: two uninterrupted runs are "
            "bit-identical on the card; the resume gate is bit equality")
        limit = 0.0
    else:
        limit = min(ctrl_err, CKPT_RESUME_CAP)
        log(f"[ckpt] trainer control pair differs: worst leaf {ctrl_leaf} "
            f"{ctrl_err:.3g} of its largest magnitude (a device op that "
            f"does not repeat itself run to run); resume gate {limit:.3g}")
    nbytes = _stored_nbytes(torch, full)
    free = _check_disk(tmp, nbytes)
    two = arm(CKPT_CUT, "--ckpt", path)                # arm 2
    if checkpoint_step(path) != CKPT_CUT:
        raise AssertionError(f"[ckpt] trainer file at step "
                             f"{checkpoint_step(path)}, not {CKPT_CUT}")
    size = _file_bytes(path)
    save_s = two.chunks[-1]["ckpt_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_method_state(path, two.state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_equal, load_err, load_leaf = _ckpt_diff(torch, loaded, two.state)
    if not load_equal:
        raise AssertionError(f"[ckpt] the trainer file does not load bit "
                             f"for bit: {load_leaf} off by {load_err:.3g}")
    planted = _ckpt_diff(torch, _one_ulp_row(torch, loaded, 0), two.state)
    if planted[0]:
        raise AssertionError("[ckpt] planted fault: a state one ulp off "
                             "passed the load gate")
    driver, data_seed = two.driver, two.data_seed
    del two
    _check_disk(tmp, nbytes)
    three = arm(CKPT_STEPS, "--ckpt", path, "--resume")  # arm 3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_drill
    counts = _launch_counts()
    # train() resets the peak at each logged chunk: the drill's peak is
    # the largest chunk's or what came after it (the load check)
    peak = max(chunk_peaks + [torch.cuda.max_memory_allocated() / 1e9])
    leaves = len(tree.leaves(full.x))
    rounds = 2 * CKPT_STEPS + CKPT_STEPS
    _gate_launches("ckpt", counts, {"dasha_mvr_update": leaves * rounds})
    if three.start_step != CKPT_CUT or three.state.t != CKPT_STEPS:
        raise AssertionError(f"[ckpt] resumed from step {three.start_step} "
                             f"to {three.state.t}")
    res_equal, res_err, res_leaf = _ckpt_diff(torch, three.state, full)
    second_save_s = three.chunks[-1]["ckpt_s"]
    resumed_state = three.state
    del three

    def passes(state):
        eq, err, _ = _ckpt_diff(torch, state, full)
        return eq if ctrl_equal else err <= limit

    if not passes(resumed_state):
        raise AssertionError(f"[ckpt] resumed trainer state off the "
                             f"uninterrupted one: {res_leaf} {res_err:.3g} "
                             f"(control pair {ctrl_err:.3g}, gate {limit})")
    del resumed_state
    # planted faults: one h_local row one ulp off (or, when the gate has a
    # tolerance, off by ten times it), and the round index one off with
    # the rounds a resume from that step would run
    bumped = _one_ulp_row(torch, loaded, 0,
                          by=None if ctrl_equal else 10 * limit)
    bad_row, _ = driver.run(bumped, CKPT_STEPS - CKPT_CUT,
                            data_seed=data_seed)
    del bumped
    bad_start, _ = driver.run(loaded._replace(t=loaded.t + 1),
                              CKPT_STEPS - CKPT_CUT - 1, data_seed=data_seed)
    for name, st in (("h_local row one ulp off", bad_row),
                     ("start round one off", bad_start)):
        if passes(st):
            raise AssertionError(f"[ckpt] planted fault ({name}) passed the "
                                 "trainer's resume gate")
    del bad_row, bad_start, loaded, full, driver
    out = {"layers": CKPT_LAYERS, "steps": CKPT_STEPS, "cut": CKPT_CUT,
           "file_bytes": size, "reckoned_bytes": nbytes,
           "free_bytes_before": free, "save_s": save_s,
           "save_s_resumed_arm": second_save_s, "load_s": load_s,
           "save_GBps": size / save_s / 1e9, "load_GBps": size / load_s / 1e9,
           "control_bit_equal": ctrl_equal, "control_worst": ctrl_err,
           "control_worst_leaf": ctrl_leaf, "resume_bit_equal": res_equal,
           "resume_worst": res_err, "resume_gate": limit,
           "peak_mem_gb": peak, "launches": counts, "wall_s": wall}
    log(f"[ckpt] 18a trainer mamba2-780m {CKPT_LAYERS}/48 layers: file "
        f"{size / 1e9:.3f} GB (reckoned {nbytes / 1e9:.3f}), save "
        f"{save_s:.2f} s = {out['save_GBps']:.2f} GB/s (resumed arm's "
        f"{second_save_s:.2f} s), load {load_s:.2f} s = "
        f"{out['load_GBps']:.2f} GB/s, bit-exact; resume vs uninterrupted "
        f"{'bit-equal' if res_equal else f'{res_err:.3g}'} beside the "
        f"control pair's {'bit-equal' if ctrl_equal else f'{ctrl_err:.3g}'}"
        f"; planted faults caught; peak {peak:.2f} GB; launches {counts}; "
        f"{wall:.1f} s | {smi}")
    return out, counts


def _ckpt_campaign(torch, smi: str, tmp: str, tag: str, build, rounds: int,
                   chunk: int, kill: int, metric):
    """Kill a campaign after chunk ``kill`` (its hook saves the state with
    the next round and the wall clock, then raises), restore it from disk
    into a fresh simulator and finish; gate the tail and the final state
    bit for bit against an uninterrupted run, with the two planted
    faults."""
    from repro_torch.checkpoint import (checkpoint_meta, load_method_state,
                                        save_method_state)

    class Killed(RuntimeError):
        pass

    path = os.path.join(tmp, tag)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t_drill = time.perf_counter()
    sim, st = build()
    full = sim.run(st, rounds, metric_fn=metric)
    nbytes = _stored_nbytes(torch, st)
    saves = []

    def hook(state, next_round, now):
        _check_disk(tmp, nbytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_method_state(path, state, step=next_round,
                          extra={"wall_clock": now})
        saves.append(time.perf_counter() - t0)
        if len(saves) == kill + 1:
            raise Killed

    sim, st = build()
    killed = False
    try:
        sim.run(st, rounds, metric_fn=metric, checkpoint=hook)
    except Killed:
        killed = True
    if not killed:
        raise AssertionError(f"[ckpt] {tag}: the campaign was not killed")
    del sim, st
    sim, like = build()                    # "a new process"
    meta = checkpoint_meta(path)
    cut = int(meta["step"])
    if cut != (kill + 1) * chunk:
        raise AssertionError(f"[ckpt] {tag}: file at round {cut}")
    clock0 = float(meta["extra"]["wall_clock"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = load_method_state(path, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del like
    res = sim.run(restored, rounds, metric_fn=metric, start_round=cut,
                  clock0=clock0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_drill
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = _drill_mismatch(torch, full, res, cut)
    if bad:
        raise AssertionError(f"[ckpt] {tag}: resumed campaign differs from "
                             f"the uninterrupted one in {bad}")
    for name, state, start in (
            ("h_local row one ulp off", _one_ulp_row(torch, restored, 0),
             cut),
            ("start round one off", restored, cut + 1)):
        got = sim.run(state, rounds, metric_fn=metric, start_round=start,
                      clock0=clock0)
        if not _drill_mismatch(torch, full, got, cut):
            raise AssertionError(f"[ckpt] {tag}: planted fault ({name}) "
                                 "passed the gate")
        del got
    size = _file_bytes(path)
    out = {"rounds": rounds, "chunk": chunk, "killed_after_chunk": kill,
           "cut": cut, "file_bytes": size, "reckoned_bytes": nbytes,
           "saves": len(saves), "save_s": saves,
           "save_GBps": [size / v / 1e9 for v in saves], "load_s": load_s,
           "load_GBps": size / load_s / 1e9, "peak_mem_gb": peak,
           "launches": counts, "wall_s": wall,
           "traces": sorted(full.traces)}
    log(f"[ckpt] {tag}: {rounds} rounds in chunks of {chunk}, killed after "
        f"chunk {kill} (round {cut}); file {size / 1e9:.4f} GB, {len(saves)}"
        f" saves {min(saves):.3f}-{max(saves):.3f} s = "
        f"{size / max(saves) / 1e9:.2f}-{size / min(saves) / 1e9:.2f} GB/s, "
        f"load {load_s:.3f} s = {out['load_GBps']:.2f} GB/s; tail traces "
        f"and final state bit-equal, planted faults caught; peak "
        f"{peak:.2f} GB; launches {counts}; {wall:.1f} s | {smi}")
    del full, res, restored, sim
    return out, counts


def _ckpt_vec(torch, smi: str, tmp: str):
    """18b: phase 12b's sampled campaign on the slab store."""
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification

    n, c, d = HEAP_N, FED_C, D_REALSIM
    feats, labels = synthetic_classification(1, n, 1, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)

    def build():
        sim = _fed_sim(problem, n, d, c, hyper_kw=dict(L=L),
                       chunk=CKPT_VEC_CHUNK)
        if not sim.slab:
            raise AssertionError("[ckpt] VecFedSim did not take the slab "
                                 "store")
        return sim, sim.init(torch.zeros(d, device="cuda"), 3,
                             device="cuda")

    out, counts = _ckpt_campaign(
        torch, smi, tmp, "18b VecFedSim slab", build, CKPT_VEC_ROUNDS,
        CKPT_VEC_CHUNK, CKPT_VEC_KILL, lambda s: torch.sum(s.g ** 2))
    # the full run, the killed one and the resumed tail: one fused update
    # a round, two writebacks a chunk
    rounds = 2 * CKPT_VEC_ROUNDS
    chunks = 2 * (CKPT_VEC_ROUNDS // CKPT_VEC_CHUNK)
    _gate_launches("ckpt", counts, {"dasha_sparsify_update": rounds,
                                    "slab_writeback": 2 * chunks})
    del problem, feats, labels
    return dict(out, n=n, C=c, d=d, K=K_RANDK, store="slab"), counts


def _ckpt_heap(torch, smi: str, tmp: str):
    """18c: the faulted heap campaign on phase 15's data."""
    from repro_torch.bench import common as bc
    from repro_torch.bench import fed_faults as ff
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import FaultModel, FedSim
    from repro_torch.methods import FlatSubstrate

    n, m, d, k = FAULT_N, FAULT_M, D_REALSIM, K_RANDK
    problem = ff.make_problem(d, n, m, device="cuda")
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend="fused",
                               device="cuda")
    hp = bc.theory_hyper("dasha", rc.omega, bc.lipschitz_glm(problem), d=d,
                         k=k, n=n, m=m)
    fm = FaultModel(**ff.EQUIV_FAULTS["dasha"])

    def build():
        sim = FedSim("dasha", rc, sub, hp, compute_s=0.0, seed=ff.NET_SEED,
                     faults=fm, chunk=CKPT_HEAP_CHUNK, **ff.links())
        return sim, sim.init(torch.zeros(d, device="cuda"), 1,
                             device="cuda")

    out, counts = _ckpt_campaign(
        torch, smi, tmp, "18c FedSim faulted", build, CKPT_HEAP_ROUNDS,
        CKPT_HEAP_CHUNK, CKPT_HEAP_KILL, None)
    _gate_launches("ckpt", counts, {"dasha_sparsify_update": 2 * CKPT_HEAP_ROUNDS})
    del problem, sub
    return dict(out, n=n, m=m, d=d, K=k, faults=ff.EQUIV_FAULTS["dasha"]), \
        counts


def phase_ckpt(torch, smi: str):
    """Phase 18: full-state checkpoints, kill and restore through files
    for the trainer (18a), VecFedSim on the slab store (18b) and the
    faulted heap FedSim (18c).  Returns the report and the launches of
    kernels 1, 3 and 4 in the drills' main-path runs."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    log(f"[ckpt] files under {tmp}; cuts: {CKPT_CUTS}")
    try:
        trainer, t_counts = _ckpt_trainer(torch, smi, tmp)
        vec, v_counts = _ckpt_vec(torch, smi, tmp)
        heap, h_counts = _ckpt_heap(torch, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"dasha_sparsify_update": v_counts["dasha_sparsify_update"]
                + h_counts["dasha_sparsify_update"],
                "dasha_mvr_update": t_counts["dasha_mvr_update"],
                "slab_writeback": v_counts["slab_writeback"]}
    wall = time.perf_counter() - t_phase
    log(f"[ckpt] phase 18 in {wall:.1f} s; launches {launches} | {smi}")
    return {"trainer": trainer, "vec": vec, "heap": heap, "cuts": CKPT_CUTS,
            "launches": launches, "wall_s": wall, "nvidia_smi": smi}, \
        launches


# ---------------------------------------------------------------------------
# phase 19: the dense GQA family (starcoder2-3b) and Figure 4
# ---------------------------------------------------------------------------

def _dense_launch_gate(tag: str, counts: dict, leaves: int,
                       rounds: int) -> None:
    """The dense trainer's launches: kernel 3 once per parameter leaf a
    round (16 leaves for starcoder2) and no other kernel."""
    want = {"dasha_mvr_update": leaves * rounds}
    if leaves != DENSE_LEAVES:
        raise AssertionError(f"[{tag}] {leaves} parameter leaves, expected "
                             f"{DENSE_LEAVES}")
    _gate_launches(tag, counts, want)


def _dense_trainer(torch, smi: str):
    """19a: ``launch.train.train`` on starcoder2-3b at full width cut to
    DENSE_TRAIN_LAYERS layers, phase 5's n = 4 x 2 x 512, DASHA-MVR with
    kernel 3 and an Adam server, the counters zeroed before and read
    after."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              num_layers=DENSE_TRAIN_LAYERS)
    rounds = DENSE_TRAIN_WARMUP + DENSE_TRAIN_ROUNDS
    args = _train_args(["--arch", "starcoder2-3b", "--steps", str(rounds),
                        "--log-every", str(DENSE_TRAIN_WARMUP), "--variant",
                        "mvr", "--use-kernel"])
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, args, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = _launch_counts()
    leaves = len(tree.leaves(res.state.x))
    _dense_launch_gate("dense-train", counts, leaves, rounds)
    peak = max(c["peak_mem_gb"] for c in res.chunks)
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses) or \
            not losses[-1] < res.loss0:
        raise AssertionError(f"[dense-train] eval loss {res.loss0} -> "
                             f"{losses}: must be finite and end lower")
    timed = res.chunks[1:]                      # the first chunk warms up
    wall = sum(c["seconds"] for c in timed)
    timed_rounds = rounds - DENSE_TRAIN_WARMUP
    tokens = TRAIN_NODES * TRAIN_BATCH * TRAIN_SEQ
    k3_bound = res.n_params * TRAIN_NODES * 29 / HBM_BYTES_PER_S * 1e3
    # the profiled rounds take the state out of ``res``, so that the
    # driver frees it after its first round (two states do not fit)
    box = [res.state]
    res.state = None
    table, pwall = profiled(torch, lambda: box.append(res.driver.run(
        box.pop(), TRAIN_PROFILED, data_seed=res.data_seed)[0]))
    busy_s = sum(t for _, t in table.values()) / 1e6
    k3_ms = sum(t for k, (_, t) in table.items()
                if "dasha_mvr_update" in k) / 1e3 / TRAIN_PROFILED
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:10]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    out = {"layers": DENSE_TRAIN_LAYERS, "of_layers": 30,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
           "vocab_padded": cfg.padded_vocab, "params": res.n_params,
           "leaves": leaves, "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "rounds_timed": timed_rounds,
           "rounds_per_s": timed_rounds / wall,
           "tokens_per_s": timed_rounds * tokens / wall,
           "round_ms": wall / timed_rounds * 1e3, "peak_mem_gb": peak,
           "card_gb": total_gb, "free_at_peak_gb": total_gb - peak,
           "eval_loss_start": res.loss0, "eval_loss_end": losses[-1],
           "launches": counts, "kernel3_launches_per_round":
               counts["dasha_mvr_update"] / rounds,
           "kernel_device_ms_per_round": k3_ms,
           "kernel_bound_ms_per_round": k3_bound,
           "profile": {"rounds": TRAIN_PROFILED, "wall_s": pwall,
                       "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                       "device_launches_per_round":
                           sum(c for c, _ in table.values()) / TRAIN_PROFILED,
                       "top_kernels": [[k[:90], c, us / 1e3]
                                       for k, (c, us) in top]},
           "chunks": res.chunks, "card": smi}
    log(f"[dense-train] starcoder2-3b {DENSE_TRAIN_LAYERS}/30 layers, "
        f"{res.n_params / 1e6:.1f}M params, {leaves} leaves ({smi}): "
        f"{out['rounds_per_s']:.3f} rounds/s, {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak:.2f} GB of {total_gb:.1f} GB, eval loss "
        f"{res.loss0:.4f} -> {losses[-1]:.4f}, kernel 3 "
        f"{out['kernel3_launches_per_round']:.0f} launches a round, "
        f"{k3_ms:.3f} ms device a round vs a {k3_bound:.3f} ms bound; "
        f"device busy {busy_s / pwall:.3f}")
    for k, c, ms in out["profile"]["top_kernels"]:
        log(f"[dense-train]   {ms:9.3f} ms  x{c:<5d} {k}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def dense_prefill_bound(cfg, batch: int, seq: int, n_params: int):
    """The least time of a last-position prefill: its bf16 tensor-core
    operations (every layer's projections and MLP for each token, the
    causal window's QK^T and PV products over the keys each query sees,
    the head at the last position) against reading the weights once."""
    per_layer = (n_params - 2 * cfg.padded_vocab * cfg.d_model) \
        / cfg.num_layers
    W = cfg.sliding_window or seq
    keys = sum(min(p + 1, W) for p in range(seq))        # per sequence
    attn = 4 * cfg.head_dim * cfg.num_heads * keys * batch
    flops = cfg.num_layers * (2 * per_layer * batch * seq + attn) \
        + 2 * batch * cfg.d_model * cfg.padded_vocab
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = 2 * n_params / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")), flops


def dense_decode_bound(cfg, batch: int, T: int, n_params: int):
    """The least time of one decode step: read the weights (the embedding
    only at the batch's rows) and the KV cache once, write one slot; its
    bf16 operations beside it."""
    embed = cfg.padded_vocab * cfg.d_model
    kv = 2 * cfg.num_layers * batch * T * cfg.num_kv_heads * cfg.head_dim
    nbytes = 2 * (n_params - embed + batch * cfg.d_model) + 2 * kv
    flops = 2 * (n_params - embed) * batch + 2 * kv * (
        cfg.num_heads // cfg.num_kv_heads)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else
            (t_ops, "operations")), nbytes


def _dense_serve(torch, smi: str):
    """19b: starcoder2-3b at DENSE_SERVE_LAYERS of 30 layers in bf16 through
    the serving
    entry points: ``prefill_logits`` of 4 x 8,192 tokens (two windows:
    the streaming path and the window mask), ``serve`` at batch 128, and
    decode steps at batch 128 on the 4,096-slot ring cache, wrapping."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm

    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              num_layers=DENSE_SERVE_LAYERS)
    L = cfg.num_layers
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    out = {"layers": L, "of_layers": 30, "params": n_params, "card": smi}

    # prefill
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size,
                               seq_len=DENSE_PREFILL_SEQ)
    tokens = make_lm_batch(1, text, DENSE_PREFILL_BATCH,
                           device="cuda")["tokens"]
    _reset_launch_counts()
    logits = S.prefill_logits(cfg, params, tokens)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(DENSE_PREFILL_TIMED):
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (DENSE_PREFILL_BATCH, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[dense-serve] prefill logits "
                             f"{tuple(logits.shape)} misshapen or not "
                             "finite")
    # the profiled call runs DENSE_PROFILED_LAYERS of the 30 identical
    # layers (the profiler's tables of a whole call's ~10^5 launches take
    # minutes to build)
    cut = dataclasses.replace(cfg, num_layers=DENSE_PROFILED_LAYERS)
    cut_params = dict(params, layers=tree.map_leaves(
        lambda w: w[:DENSE_PROFILED_LAYERS], params["layers"]))
    table, pwall = profiled(torch, lambda: S.prefill_logits(cut, cut_params,
                                                            tokens))
    busy_s = sum(t for _, t in table.values()) / 1e6
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:10]
    (b_ms, by), flops = dense_prefill_bound(cfg, DENSE_PREFILL_BATCH,
                                            DENSE_PREFILL_SEQ, n_params)
    wall = sum(walls) / len(walls)
    ntok = DENSE_PREFILL_BATCH * DENSE_PREFILL_SEQ
    out["prefill"] = {
        "batch": DENSE_PREFILL_BATCH, "seq": DENSE_PREFILL_SEQ,
        "walls_s": walls, "tokens_per_s": ntok / wall,
        "peak_mem_gb": peak / 1e9, "bound_ms": b_ms, "bound_by": by,
        "flops": flops, "bound_share": b_ms / (wall * 1e3),
        "launches": _launch_counts(),
        "profile": {"layers": DENSE_PROFILED_LAYERS, "wall_s": pwall,
                    "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                    "launches": sum(c for c, _ in table.values()),
                    "top_kernels": [[k[:90], c, us / 1e3]
                                    for k, (c, us) in top]}}
    log(f"[dense-serve] starcoder2-3b {L}/30 layers, {n_params / 1e6:.1f}M "
        f"params, bf16 ({smi}): prefill {DENSE_PREFILL_BATCH} x "
        f"{DENSE_PREFILL_SEQ} in {walls} s, {ntok / wall:.0f} tokens/s, "
        f"peak {peak / 1e9:.2f} GB, bound {b_ms:.1f} ms ({by}, "
        f"{flops / 1e12:.1f} TFLOP at the bf16 rate); a profiled call of "
        f"{DENSE_PROFILED_LAYERS} layers {pwall:.3f} s, device busy "
        f"{busy_s / pwall:.3f}")
    for k, c, ms in out["prefill"]["profile"]["top_kernels"]:
        log(f"[dense-serve]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens
    torch.cuda.empty_cache()

    # serve: the entry point at batch 128 (a short prompt stepped through
    # decode_step, greedy decode)
    args = S.build_parser().parse_args([
        "--arch", "starcoder2-3b", "--batch", str(DENSE_DECODE_BATCH),
        "--prompt-len", str(DENSE_SERVE_PROMPT), "--new-tokens",
        str(DENSE_SERVE_NEW)])
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    if res.tokens.shape != (DENSE_DECODE_BATCH, DENSE_SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"[dense-serve] serve tokens "
                             f"{res.tokens.shape} misshapen or out of the "
                             "vocabulary")
    out["serve"] = {"batch": DENSE_DECODE_BATCH,
                    "prompt": DENSE_SERVE_PROMPT, "new": DENSE_SERVE_NEW,
                    "prompt_ms_per_step":
                        res.prefill_s / DENSE_SERVE_PROMPT * 1e3,
                    "decode_ms_per_step":
                        res.decode_s / DENSE_SERVE_NEW * 1e3,
                    "first_row": res.tokens[0].tolist()}
    del res
    torch.cuda.empty_cache()

    # decode on the full ring: 4,096 slots of a written history (random
    # K/V: the step's time does not depend on their values), from 16
    # positions before the wrap to 16 after it
    T = cfg.sliding_window
    cache = lm.init_cache(cfg, DENSE_DECODE_BATCH, T + DENSE_DECODE_STEPS,
                          device="cuda")
    if cache["k"].shape[2] != T:
        raise AssertionError(f"[dense-serve] cache {tuple(cache['k'].shape)}"
                             f": expected a ring of {T} slots")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for c in cache.values():
        c.normal_(generator=gen)
    t0 = T - DENSE_DECODE_STEPS // 2
    tok = torch.randint(1, cfg.vocab_size, (DENSE_DECODE_BATCH,),
                        device="cuda", generator=gen)

    def steps(first: int, count: int):
        nonlocal tok
        with torch.inference_mode():
            for i in range(count):
                logits, _ = lm.decode_step(cfg, params, cache, tok,
                                           first + i)
                tok = S.greedy(cfg, logits)
        return logits

    steps(t0 - 2, 2)                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    last = steps(t0, DENSE_DECODE_STEPS)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t1
    dpeak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("[dense-serve] decode logits not finite")
    table, pwall = profiled(torch, lambda: steps(t0 + DENSE_DECODE_STEPS,
                                                 DENSE_DECODE_PROFILED))
    busy_s = sum(t for _, t in table.values()) / 1e6
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    (db_ms, dby), dbytes = dense_decode_bound(cfg, DENSE_DECODE_BATCH, T,
                                              n_params)
    ms = dwall / DENSE_DECODE_STEPS * 1e3
    cache_gb = sum(c.numel() * c.element_size() for c in cache.values()) / 1e9
    out["decode"] = {
        "batch": DENSE_DECODE_BATCH, "ring_slots": T,
        "positions": [t0, t0 + DENSE_DECODE_STEPS - 1],
        "steps": DENSE_DECODE_STEPS, "ms_per_step": ms,
        "tokens_per_s": DENSE_DECODE_BATCH / (ms / 1e3),
        "cache_gb": cache_gb, "peak_mem_gb": dpeak / 1e9,
        "bound_ms": db_ms, "bound_by": dby, "bound_bytes": dbytes,
        "profile": {"steps": DENSE_DECODE_PROFILED, "wall_s": pwall,
                    "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                    "kernels_per_step": sum(c for c, _ in table.values())
                    / DENSE_DECODE_PROFILED,
                    "top_kernels": [[k[:90], c, us / 1e3]
                                    for k, (c, us) in top]}}
    log(f"[dense-serve] decode batch {DENSE_DECODE_BATCH} on the {T}-slot "
        f"ring ({smi}), positions {t0}..{t0 + DENSE_DECODE_STEPS - 1}: "
        f"{ms:.2f} ms a step vs a {db_ms:.2f} ms bound ({dby}), cache "
        f"{cache_gb:.2f} GB, peak {dpeak / 1e9:.2f} GB, device busy "
        f"{busy_s / pwall:.3f}, "
        f"{out['decode']['profile']['kernels_per_step']:.0f} kernels a step")
    for k, c, ms_k in out["decode"]["profile"]["top_kernels"]:
        log(f"[dense-serve]   {ms_k:9.3f} ms  x{c:<5d} {k}")
    del cache, params, last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel_gap(got, want) -> float:
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float().cpu() - want.float()).abs().max()) / scale


def _dense_model_agreement(torch):
    """19c: the three smoke configs in float32 on the card and on the
    CPU, the same params and tokens: prefill logits by the dense path (64
    tokens) and the streaming one (2,048), and 24 teacher-forced decode
    steps (past the 16-slot smoke ring), each within DENSE_AGREE_LIMIT of
    the largest CPU logit.  Planted faults (starcoder2): the streaming
    prefill without its window, and decode on the ring's cache written at
    t (clamped, no window) instead of t % T, must each fail it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm

    worst, planted, by_arch = 0.0, {}, {}
    gen = torch.Generator().manual_seed(7)
    for arch in ("starcoder2-3b", "minitron-8b", "qwen1.5-110b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = init_params(cfg, 0, device="cpu")
        dev_params = tree.map_leaves(lambda p: p.to("cuda"), params)
        errs = {}
        for name, shape in (("prefill_dense", (2, 64)),
                            ("prefill_streaming",
                             (1, DENSE_AGREE_STREAM_SEQ))):
            tok = torch.randint(1, cfg.vocab_size, shape, generator=gen)
            want = S.prefill_logits(cfg, params, tok)
            errs[name] = _rel_gap(S.prefill_logits(cfg, dev_params,
                                                   tok.to("cuda")), want)
            if name == "prefill_streaming" and cfg.sliding_window:
                nowin = dataclasses.replace(cfg, sliding_window=0)
                planted["streaming prefill without its window"] = _rel_gap(
                    S.prefill_logits(nowin, dev_params, tok.to("cuda")),
                    want)
        B, steps = 2, DENSE_DECODE_AGREE_STEPS
        tok = torch.randint(1, cfg.vocab_size, (B, steps), generator=gen)
        caches = {d: lm.init_cache(cfg, B, steps, device=d)
                  for d in ("cpu", "cuda")}
        ring_fault = lm.init_cache(cfg, B, steps, device="cuda") \
            if cfg.sliding_window else None
        flat = dataclasses.replace(cfg, sliding_window=0)
        err = fault = 0.0
        with torch.inference_mode():
            for t in range(steps):
                want, _ = lm.decode_step(cfg, params, caches["cpu"],
                                         tok[:, t], t)
                got, _ = lm.decode_step(cfg, dev_params, caches["cuda"],
                                        tok[:, t].to("cuda"), t)
                err = max(err, _rel_gap(got, want))
                if ring_fault is not None:
                    bad, _ = lm.decode_step(flat, dev_params, ring_fault,
                                            tok[:, t].to("cuda"), t)
                    fault = max(fault, _rel_gap(bad, want))
        errs["decode"] = err
        if ring_fault is not None:
            planted["ring written at t, not t % T"] = fault
        by_arch[arch] = errs
        worst = max([worst] + list(errs.values()))
    if not worst <= DENSE_AGREE_LIMIT:
        raise AssertionError(f"[dense-agree] card and CPU logits differ: "
                             f"{by_arch} (limit {DENSE_AGREE_LIMIT})")
    missed = {k: v for k, v in planted.items()
              if not v > DENSE_AGREE_LIMIT}
    if len(planted) != 2 or missed:
        raise AssertionError(f"[dense-agree] planted faults pass the gate: "
                             f"{planted}")
    log(f"[dense-agree] smoke starcoder2 / minitron / qwen1.5 f32, card vs "
        f"CPU (dense and streaming prefill, {DENSE_DECODE_AGREE_STEPS} "
        f"decode steps past the 16-slot ring): worst {worst:.3g} of max "
        f"|logit| (limit {DENSE_AGREE_LIMIT}); planted {planted}")
    return {"worst": worst, "by_arch": by_arch, "planted": planted}


def _replay_draws(torch, params, dcfg, rounds: int):
    """The tree trainer's per-leaf masks for ``rounds`` + 1 rounds, drawn
    on the CPU from a fixed seed."""
    from repro_torch.compress import treelevel
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws, RoundRandom
    n = dcfg.n_nodes
    zeros = tree.map_leaves(lambda p: torch.zeros((n,) + tuple(p.shape)),
                            params)
    return [Draws(masks=treelevel.tree_masks(
        RoundRandom(9, t), zeros, mode="independent", p=dcfg.compression,
        n=n)[0]) for t in range(rounds + 1)]


def _replayed_trainer(torch, cfg, dcfg, params, batches, draws, dev,
                      use_kernel: bool, shift: int = 0):
    """``len(batches)`` rounds of ``make_method(dcfg)`` on ``cfg`` from
    ``params`` on ``dev``, round t on ``batches[t]`` and ``draws[t +
    shift]``, the counters zeroed before: (final state, launches)."""
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws
    from repro_torch.methods import Driver
    from repro_torch.models import lm
    from repro_torch.optim.distributed import make_method
    method = make_method(dataclasses.replace(dcfg, use_kernel=use_kernel),
                         lambda p, b: lm.loss_fn(cfg, p, b)[0])
    state = method.init(tree.map_leaves(lambda p: p.to(dev), params), 1,
                        init_mode="zeros", device=dev)
    dev_draws = [Draws(masks=tree.map_leaves(lambda m: m.to(dev), d.masks))
                 for d in draws]

    def step(s, data):
        return method.step_full(s, data, draws=dev_draws[s.t + shift])[0]

    _reset_launch_counts()
    final, _ = Driver(step, data_fn=lambda seed, t: {
        k: v.to(dev) for k, v in batches[t].items()}).run(
        state, len(batches), data_seed=0)
    return final, _launch_counts()


def _dense_trainer_agreement(torch):
    """19d: starcoder2 smoke in float32 trained on the card and on the CPU
    with the same CPU-drawn masks and batches, dasha and mvr x kernel off
    / on, DENSE_AGREE_ROUNDS rounds, SGD server: the states within
    DENSE_AGREE_LIMIT of each leaf's largest magnitude.  Planted faults:
    the card run on the next round's masks must fail that gate, and the
    plain route's launches must fail the trainer's launch gate."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches)
    from repro_torch.models import init_params
    from repro_torch.optim.distributed import DashaTrainConfig

    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              dtype="float32")
    n, rounds = TRAIN_NODES, DENSE_AGREE_ROUNDS
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batches = [make_node_batches(t, text, n, 2, device="cpu")
               for t in range(rounds)]
    params = init_params(cfg, 0, device="cpu")
    worst, errs, planted = 0.0, {}, {}
    for variant in ("dasha", "mvr"):
        dcfg = DashaTrainConfig(gamma=0.05, compression=0.25,
                                variant=variant, b=0.1, n_nodes=n,
                                server_opt="sgd")
        draws = _replay_draws(torch, params, dcfg, rounds)

        def run(dev, use_kernel, shift=0):
            return _replayed_trainer(torch, cfg, dcfg, params, batches,
                                     draws, dev, use_kernel, shift)

        cpu, _ = run("cpu", False)
        for use_kernel in (False, True):
            card, counts = run("cuda", use_kernel)
            tag = f"{variant}/kernel={use_kernel}"
            try:
                errs[tag] = _states_agree(torch, card, cpu,
                                          DENSE_AGREE_LIMIT)
            except AssertionError as e:
                raise AssertionError(f"[dense-agree] trainer {tag}: {e}") \
                    from None
            worst = max(worst, errs[tag])
            if variant == "mvr" and not use_kernel:
                try:
                    _dense_launch_gate("planted", counts,
                                       len(tree.leaves(params)), rounds)
                except AssertionError as e:
                    planted["plain route under the launch gate"] = str(e)
                else:
                    raise AssertionError("[dense-agree] the plain route's "
                                         f"launches {counts} pass the "
                                         "trainer's launch gate")
        shifted, _ = run("cuda", True, shift=1)
        try:
            _states_agree(torch, shifted, cpu, DENSE_AGREE_LIMIT)
        except AssertionError as e:
            planted[f"{variant} on the next round's masks"] = str(e)[:120]
        else:
            raise AssertionError(f"[dense-agree] {variant} on the next "
                                 "round's masks passes the state gate")
    log(f"[dense-agree] trainer, starcoder2 smoke f32, dasha/mvr x kernel "
        f"off/on, {rounds} rounds with injected CPU masks and batches: card "
        f"vs CPU worst {worst:.3g} of a leaf's largest magnitude (limit "
        f"{DENSE_AGREE_LIMIT}); planted faults caught: {sorted(planted)}")
    return {"worst": worst, "by_route": errs, "planted": planted}


def _fig4_lane_errors(torch, lanes_state, j: int, seq, init) -> dict:
    """Lane ``j``'s distance from a sequential run, per state field: the
    largest leaf error relative to how far the sequential run moved that
    leaf from the start (a lane run at its neighbour's gamma is ~1 off),
    and the largest absolute difference."""
    from repro_torch.core import tree
    out = {}
    for f in SWEEP_STATE:
        rel = diff = 0.0
        for path, w in tree.items(getattr(seq, f)):
            g = tree.get(getattr(lanes_state, f), path)[j].float()
            w, w0 = w.float(), tree.get(getattr(init, f), path).float()
            d = float((g - w).abs().max())
            move = float((w - w0).abs().max())
            diff = max(diff, d)
            rel = max(rel, d / move if move > 0 else (0.0 if d == 0
                                                       else math.inf))
        out[f] = {"rel_to_move": rel, "max_abs": diff}
    return out


def _dense_fig4(torch, smi: str):
    """19e: Figure 4 on the card at FIG4_STEPS of its STEPS (the three
    3-lane sweeps on the tree substrate and the Adam baseline), each row with
    its wall seconds; then dasha_1/32's lowest- and highest-gamma lanes
    (FIG4_CHECKED_LANES) against sequential Driver runs at their gammas
    over the same rounds (bits_sent exactly, every state field within
    FIG4_LANE_RTOL of the run's move from the start, the eval losses
    within FIG4_LOSS_RTOL), where each lane held against the other's run
    must fail."""
    from repro_torch.bench import fig4_dnn as F
    from repro_torch.bench.common import emit
    from repro_torch.methods import Driver

    t0 = time.perf_counter()
    rows, sweeps, (cfg, params, data_fn, fixed) = F.figure(
        torch.device("cuda"), FIG4_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[fig4] Figure 4 at {FIG4_STEPS} of {F.STEPS} steps on the card "
        f"({smi}): {wall:.2f} s")
    emit(rows)
    if not all(math.isfinite(r["final_loss"]) for r in rows):
        raise AssertionError(f"[fig4] a row's loss is not finite: {rows}")

    name, kw = F.METHODS[0]
    finals, lane_losses = sweeps[name]
    init = F.init_state(cfg, kw, params, device="cuda")
    method_fn = F.method_fn_of(cfg, kw)
    seqs, checks = {}, []
    for j in FIG4_CHECKED_LANES:
        gamma = F.GAMMAS[j]
        seq, _ = Driver(method_fn(gamma), data_fn=data_fn,
                         chunk=F.CHUNK).run(init, FIG4_STEPS,
                                            data_seed=F.DATA_SEED)
        seqs[j] = seq
        loss = F.eval_loss(cfg, seq.x, fixed)
        errs = _fig4_lane_errors(torch, finals, j, seq, init)
        loss_rel = abs(lane_losses[j] - loss) / abs(loss)
        bad = {f: e for f, e in errs.items()
               if not e["rel_to_move"] <= FIG4_LANE_RTOL}
        if bad or not loss_rel <= FIG4_LOSS_RTOL or \
                float(finals.bits_sent[j]) != float(seq.bits_sent):
            raise AssertionError(f"[fig4] lane {j} (gamma {gamma}) off its "
                                 f"sequential run: {bad}, loss {loss_rel}, "
                                 f"bits {finals.bits_sent[j]} vs "
                                 f"{seq.bits_sent}")
        checks.append({"lane": j, "gamma": gamma, "errors": errs,
                       "loss_lane": lane_losses[j], "loss_seq": loss,
                       "loss_rel_err": loss_rel})
    planted = {}
    for j, nb in zip(FIG4_CHECKED_LANES, FIG4_CHECKED_LANES[::-1]):
        errs = _fig4_lane_errors(torch, finals, j, seqs[nb], init)
        worst_f = max(e["rel_to_move"] for e in errs.values())
        if not worst_f > FIG4_LANE_RTOL:
            raise AssertionError(f"[fig4] lane {j} against gamma "
                                 f"{F.GAMMAS[nb]} passes the lane gate "
                                 f"({errs})")
        planted[f"lane {j} vs gamma {F.GAMMAS[nb]}"] = worst_f
    exact = all(e["max_abs"] == 0.0 for c in checks
                for e in c["errors"].values())
    worst = max(e["rel_to_move"] for c in checks
                for e in c["errors"].values())
    log(f"[fig4] dasha_1/32's lanes {FIG4_CHECKED_LANES} vs sequential "
        f"Driver runs over {FIG4_STEPS} steps: worst {worst:.3g} of the move "
        f"(limit {FIG4_LANE_RTOL}), bit for bit: {exact}; planted "
        f"other-gamma faults read {planted}")
    return {"rows": rows, "steps": FIG4_STEPS, "of_steps": F.STEPS,
            "wall_s": wall, "lane_checks": checks,
            "lanes_bit_equal": exact, "planted": planted}


def phase_dense(torch, smi: str):
    """Phase 19: the dense GQA family at starcoder2-3b's full width
    (trainer and serving), card against CPU at the three smoke configs,
    and Figure 4 with its lane gate.  Returns the report and kernel 3's
    launches on the trainer."""
    gc.collect()                    # earlier phases' reference cycles
    torch.cuda.empty_cache()
    held = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    log(f"[dense] before the phase: {held['allocated_gb']:.2f} GB "
        f"allocated, {held['reserved_gb']:.2f} GB reserved")
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        walls[name] = time.perf_counter() - t1
        log(f"[dense] {name} in {walls[name]:.1f} s")
        return res

    trainer, counts = part("trainer", _dense_trainer, smi)
    serving = part("serve", _dense_serve, smi)
    agree = part("agreement", _dense_model_agreement)
    train_agree = part("trainer_agreement", _dense_trainer_agreement)
    fig4 = part("fig4", _dense_fig4, smi)
    wall = time.perf_counter() - t0
    log(f"[dense] phase 19 in {wall:.1f} s")
    return {"held_before": held, "trainer": trainer, "serve": serving,
            "agreement": agree, "trainer_agreement": train_agree,
            "fig4": fig4, "cuts": DENSE_CUTS, "wall_s": wall,
            "walls_s": walls}, counts["dasha_mvr_update"]


# ---------------------------------------------------------------------------
# phase 20: gemma3's grouped local/global stack and the MoE family
# (phi3.5-moe, deepseek-v2-lite with MLA)
# ---------------------------------------------------------------------------

def _active_layer_params(cfg, params) -> float:
    """Parameters a token passes through in the transformer layers: every
    layer leaf, the routed experts' at experts_per_token / num_experts
    (the router and the shared experts whole)."""
    from repro_torch.core import tree
    total = 0.0
    for key in ("layers", "local_layers", "global_layers"):
        for path, w in tree.items(params.get(key, {})):
            n = float(w.numel())
            if cfg.num_experts and path in ("ffn/w_gate", "ffn/w_in",
                                            "ffn/w_out"):
                n *= cfg.experts_per_token / cfg.num_experts
            total += n
    return total


def _layer_kinds(cfg):
    """(layers, window) pairs: gemma3's local layers under the sliding
    window and its global layers, or every layer at the config's window."""
    if cfg.global_every:
        groups = cfg.num_layers // cfg.global_every
        return [(groups * (cfg.global_every - 1), cfg.sliding_window),
                (groups, 0)]
    return [(cfg.num_layers, cfg.sliding_window)]


def _attn_flops_per_key(cfg, decode: bool) -> float:
    """Products a query does against one key in one layer: QK^T and PV
    over every head (MLA's decode in the rank-r latent space)."""
    H = cfg.num_heads
    if not cfg.use_mla:
        return 4.0 * cfg.head_dim * H
    dr = cfg.qk_rope_head_dim
    if decode:
        return 2.0 * (2 * cfg.kv_lora_rank + dr) * H
    return 2.0 * (cfg.qk_nope_head_dim + dr + cfg.v_head_dim) * H


def family_prefill_bound(cfg, params, batch: int, seq: int, n_params: int):
    """The least time of a last-position prefill: the bf16 tensor-core
    operations of every token through its active layer parameters (K of E
    experts), the causal (windowed) attention over the keys each query
    sees, and the head at the last position, against reading the weights
    once."""
    flops = 2 * _active_layer_params(cfg, params) * batch * seq \
        + 2 * batch * cfg.d_model * cfg.padded_vocab
    per_key = _attn_flops_per_key(cfg, decode=False)
    for n, W in _layer_kinds(cfg):
        keys = sum(min(p + 1, W or seq) for p in range(seq))
        flops += n * per_key * keys * batch
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = 2 * n_params / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")), flops


def family_decode_bound(cfg, params, batch: int, t_mean: float,
                        n_params: int):
    """The least time of one decode step at position ~``t_mean``: read the
    weights once (every expert: at these batches each one is routed to;
    an untied embedding only at the batch's rows) and the cache slots a
    query sees, write one slot; its bf16 operations beside it."""
    embed = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    if cfg.use_mla:
        per_slot = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_slot = 2 * cfg.num_kv_heads * cfg.head_dim
    slots = sum(n * min(t_mean + 1, W or t_mean + 1)
                for n, W in _layer_kinds(cfg))
    cache = per_slot * batch * (slots + cfg.num_layers)
    nbytes = 2 * (n_params - embed + batch * cfg.d_model) + 2 * cache
    flops = 2 * (_active_layer_params(cfg, params)
                 + cfg.padded_vocab * cfg.d_model) * batch \
        + _attn_flops_per_key(cfg, decode=True) * slots * batch
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else
            (t_ops, "operations")), nbytes


def _cut_params(cfg, params):
    """``cfg`` and ``params`` cut to FAMILY_PROFILED_LAYERS layers: the
    homogeneous stack's first two, or gemma3's first local and first
    global layer (one group of two)."""
    from repro_torch.core import tree
    n = FAMILY_PROFILED_LAYERS
    if not cfg.global_every:
        return (dataclasses.replace(cfg, num_layers=n),
                dict(params, layers=tree.map_leaves(lambda w: w[:n],
                                                    params["layers"])))
    cut = dataclasses.replace(cfg, num_layers=n, global_every=n)
    return cut, dict(params, local_layers=tree.map_leaves(
        lambda w: w[:1, :n - 1], params["local_layers"]),
        global_layers=tree.map_leaves(lambda w: w[:1],
                                      params["global_layers"]))


def _top(table, k):
    return [[name[:90], c, us / 1e3] for name, (c, us) in
            sorted(table.items(), key=lambda kv: -kv[1][1])[:k]]


def _family_prefill(torch, smi: str, cfg, params, n_params: int, tag: str,
                    profile: bool):
    """One warm-up and FAMILY_PREFILL_TIMED timed ``prefill_logits`` calls
    of FAMILY_PREFILL_BATCH x FAMILY_PREFILL_SEQ tokens, and a call cut
    to FAMILY_PROFILED_LAYERS layers under the profiler."""
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.launch import serve as S

    B, T = FAMILY_PREFILL_BATCH, FAMILY_PREFILL_SEQ
    tokens = make_lm_batch(1, SyntheticTextConfig(vocab_size=cfg.vocab_size,
                                                  seq_len=T), B,
                           device="cuda")["tokens"]
    S.prefill_logits(cfg, params, tokens)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(FAMILY_PREFILL_TIMED):
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] prefill logits "
                             f"{tuple(logits.shape)} misshapen or not "
                             "finite")
    (b_ms, by), flops = family_prefill_bound(cfg, params, B, T, n_params)
    wall = sum(walls) / len(walls)
    out = {"batch": B, "seq": T, "dispatch": cfg.moe_dispatch
           if cfg.num_experts else None, "walls_s": walls,
           "tokens_per_s": B * T / wall, "peak_mem_gb": peak / 1e9,
           "bound_ms": b_ms, "bound_by": by, "flops": flops,
           "bound_share": b_ms / (wall * 1e3)}
    if cfg.num_experts and cfg.moe_dispatch == "gather":
        from repro_torch.models.moe import _capacity
        out["capacity"] = _capacity(cfg, B * T)
    msg = ""
    if profile:
        cut, cut_params = _cut_params(cfg, params)
        t0 = time.perf_counter()
        table, pwall = profiled(torch, lambda: S.prefill_logits(
            cut, cut_params, tokens))
        busy_s = sum(t for _, t in table.values()) / 1e6
        out["profile"] = {"layers": FAMILY_PROFILED_LAYERS, "wall_s": pwall,
                          "with_tables_s": time.perf_counter() - t0,
                          "device_busy_s": busy_s,
                          "busy_share": busy_s / pwall,
                          "launches": sum(c for c, _ in table.values()),
                          "top_kernels": _top(table, 10)}
        msg = (f"; a profiled call of {FAMILY_PROFILED_LAYERS} layers "
               f"{pwall:.3f} s, device busy {busy_s / pwall:.3f}")
    log(f"[{tag}] prefill {B} x {T} ({out['dispatch'] or 'dense'}) in "
        f"{walls} s, {B * T / wall:.0f} tokens/s, peak {peak / 1e9:.2f} GB, "
        f"bound {b_ms:.1f} ms ({by}, {flops / 1e12:.1f} TFLOP at the bf16 "
        f"rate, {out['bound_share']:.3f} of it){msg} | {smi}")
    for k, c, ms in out.get("profile", {}).get("top_kernels", []):
        log(f"[{tag}]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens
    torch.cuda.empty_cache()
    return out


def _family_decode(torch, smi: str, cfg, params, batch: int, tag: str,
                   t0: int, bound, profile: bool = True, cache_kw=None):
    """FAMILY_DECODE_STEPS decode steps at ``batch`` from position ``t0``
    on a FAMILY_DECODE_SLOTS-slot cache holding a random history
    (gemma3's 1,024-slot local rings wrap at 4,096 on the way from
    FAMILY_DECODE_T0), then, with ``profile``, FAMILY_DECODE_PROFILED steps
    under the profiler.  ``bound(cache, t_mean)`` gives the least time of
    a step: ((ms, by), bytes).  ``cache_kw`` goes to ``lm.init_cache``
    (the cross families' cross K/V, which keeps its values: only the
    self K/V under ``kv`` is filled)."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import lm

    T = FAMILY_DECODE_SLOTS
    cache = lm.init_cache(cfg, batch, T, device="cuda", **(cache_kw or {}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for c in tree.leaves(cache["kv"] if "cross" in cache else cache):
        c.normal_(generator=gen)
    tok = torch.randint(1, cfg.vocab_size, (batch,), device="cuda",
                        generator=gen)

    def steps(first: int, count: int):
        nonlocal tok
        with torch.inference_mode():
            for i in range(count):
                logits, _ = lm.decode_step(cfg, params, cache, tok,
                                           first + i)
                tok = S.greedy(cfg, logits)
        return logits

    steps(t0 - 2, 2)                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    last = steps(t0, FAMILY_DECODE_STEPS)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t1
    dpeak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"[{tag}] decode logits not finite")
    (db_ms, dby), dbytes = bound(cache, t0 + (FAMILY_DECODE_STEPS - 1) / 2)
    ms = dwall / FAMILY_DECODE_STEPS * 1e3
    cache_gb = sum(c.numel() * c.element_size()
                   for c in tree.leaves(cache)) / 1e9
    out = {"batch": batch, "slots": T,
           "positions": [t0, t0 + FAMILY_DECODE_STEPS - 1],
           "steps": FAMILY_DECODE_STEPS, "ms_per_step": ms,
           "tokens_per_s": batch / (ms / 1e3), "cache_gb": cache_gb,
           "peak_mem_gb": dpeak / 1e9, "bound_ms": db_ms, "bound_by": dby,
           "bound_bytes": dbytes, "bound_share": db_ms / ms, "profile": None}
    if cfg.global_every:
        out["local_ring_slots"] = int(cache["local"]["k"].shape[3])
    msg = ""
    if profile:
        t2 = time.perf_counter()
        table, pwall = profiled(torch, lambda: steps(
            t0 + FAMILY_DECODE_STEPS, FAMILY_DECODE_PROFILED))
        busy_s = sum(t for _, t in table.values()) / 1e6
        out["profile"] = {
            "steps": FAMILY_DECODE_PROFILED, "wall_s": pwall,
            "with_tables_s": time.perf_counter() - t2,
            "device_busy_s": busy_s, "busy_share": busy_s / pwall,
            "kernels_per_step": sum(c for c, _ in table.values())
            / FAMILY_DECODE_PROFILED, "top_kernels": _top(table, 8)}
        msg = (f", device busy {busy_s / pwall:.3f}, "
               f"{out['profile']['kernels_per_step']:.0f} kernels a step")
    log(f"[{tag}] decode batch {batch} on {T} slots, positions {t0}.."
        f"{t0 + FAMILY_DECODE_STEPS - 1}: {ms:.2f} ms a step vs a "
        f"{db_ms:.2f} ms bound ({dby}), cache {cache_gb:.2f} GB, peak "
        f"{dpeak / 1e9:.2f} GB{msg} | {smi}")
    for k, c, ms_k in (out["profile"] or {}).get("top_kernels", []):
        log(f"[{tag}]   {ms_k:9.3f} ms  x{c:<5d} {k}")
    del cache, last
    torch.cuda.empty_cache()
    return out


def _family_serve(torch, smi: str, arch: str, layers, batch: int, modes):
    """20a-c: ``arch`` at full width (``layers`` of its depth, None for
    all) in bf16 through the serving entry points: ``prefill_logits`` by
    each of the MoE dispatch ``modes`` (None: no experts), ``serve`` for
    one request batch, and decode steps on a long cache, the prefill and
    the decode profiled for FAMILY_PROFILED_ARCH only.  None of the five
    kernels may launch."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = get_config(arch)
    depth = cfg.num_layers
    profile = arch == FAMILY_PROFILED_ARCH
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tag = f"family {arch}"
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    out = {"arch": arch, "layers": cfg.num_layers, "of_layers": depth,
           "params": n_params, "params_gb": 2 * n_params / 1e9,
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi}
    log(f"[{tag}] {cfg.num_layers}/{depth} layers, {n_params / 1e9:.3f}B "
        f"params ({2 * n_params / 1e9:.1f} GB bf16) in {out['init_s']:.1f} "
        f"s, peak {out['init_peak_gb']:.1f} GB")
    walls = out["walls_s"] = {}
    t0 = time.perf_counter()
    out["prefill"] = [
        _family_prefill(torch, smi, dataclasses.replace(
            cfg, moe_dispatch=m) if m else cfg, params, n_params, tag,
            profile=profile and i == 0) for i, m in enumerate(modes)]
    walls["prefill"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    args = S.build_parser().parse_args([
        "--arch", arch, "--batch", str(batch), "--prompt-len",
        str(FAMILY_SERVE_PROMPT), "--new-tokens", str(FAMILY_SERVE_NEW)])
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    if res.tokens.shape != (batch, FAMILY_SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"[{tag}] serve tokens {res.tokens.shape} "
                             "misshapen or out of the vocabulary")
    out["serve"] = {"batch": batch, "prompt": FAMILY_SERVE_PROMPT,
                    "new": FAMILY_SERVE_NEW,
                    "prompt_ms_per_step":
                        res.prefill_s / FAMILY_SERVE_PROMPT * 1e3,
                    "decode_ms_per_step": res.decode_s / FAMILY_SERVE_NEW
                    * 1e3, "first_row": res.tokens[0].tolist()}
    del res
    walls["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["decode"] = _family_decode(
        torch, smi, cfg, params, batch, tag, FAMILY_DECODE_T0,
        lambda cache, t: family_decode_bound(cfg, params, batch, t,
                                             n_params), profile)
    walls["decode"] = time.perf_counter() - t0
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[{tag}] serving launched hand-written "
                             f"kernels: {counts}")
    out["launches"] = counts
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _family_trainer(torch, smi: str):
    """20d: ``launch.train.train`` at the three smoke configs (bf16),
    DASHA-MVR with kernel 3, gated on one launch per parameter leaf a
    round and nothing else; then one ``lm.loss_fn`` forward and backward
    of deepseek-v2-lite at full width cut to FAMILY_GRAD_LAYERS layers, in
    bf16 (the routed FFN's index scatters), gated on finite gradients and
    a non-zero router gradient."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, lm

    out, total = {}, 0
    for arch in FAMILY_ARCHS:
        cfg = get_smoke_config(arch)
        args = _train_args(["--arch", arch, "--steps",
                            str(FAMILY_TRAIN_ROUNDS), "--log-every",
                            str(FAMILY_TRAIN_ROUNDS // 2), "--variant",
                            "mvr", "--use-kernel"])
        _reset_launch_counts()
        res = train(cfg, args, device="cuda", log=log)
        torch.cuda.synchronize()
        counts = _launch_counts()
        leaves = len(tree.leaves(res.state.x))
        if leaves != FAMILY_LEAVES[arch]:
            raise AssertionError(f"[family-train] {arch}: {leaves} "
                                 f"parameter leaves, expected "
                                 f"{FAMILY_LEAVES[arch]}")
        _gate_launches(f"family-train {arch}", counts, {
            "dasha_mvr_update": leaves * FAMILY_TRAIN_ROUNDS})
        losses = [c["loss"] for c in res.chunks]
        if not all(math.isfinite(v) for v in [res.loss0] + losses):
            raise AssertionError(f"[family-train] {arch} eval loss "
                                 f"{res.loss0} -> {losses}")
        total += counts["dasha_mvr_update"]
        out[arch] = {"config": cfg.name, "params": res.n_params,
                     "leaves": leaves, "rounds": FAMILY_TRAIN_ROUNDS,
                     "launches": counts, "eval_loss_start": res.loss0,
                     "eval_loss_end": losses[-1],
                     "seconds": [c["seconds"] for c in res.chunks]}
        del res

    # the routed FFN's backward at full width
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=FAMILY_GRAD_LAYERS)
    params = init_params(cfg, 0, device="cuda")
    for w in tree.leaves(params):
        w.requires_grad_(True)
    batch = make_lm_batch(3, SyntheticTextConfig(
        vocab_size=cfg.vocab_size, seq_len=FAMILY_GRAD_SEQ),
        FAMILY_GRAD_BATCH, device="cuda")
    walls = []
    for _ in range(2):                              # warm-up, then timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, metrics = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    g = dict(zip([p for p, _ in tree.items(params)], grads))
    bad = [p for p, v in g.items() if not bool(torch.isfinite(v).all())]
    router = float(g["layers/ffn/router"].abs().max())
    loss, aux = float(loss.detach()), float(metrics["aux"].detach())
    if bad or not router > 0 or not math.isfinite(loss):
        raise AssertionError(f"[family-grad] loss {loss}, gradients not "
                             f"finite: {bad}, router |g| max {router}")
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    out["grad"] = {"arch": "deepseek-v2-lite-16b",
                   "layers": FAMILY_GRAD_LAYERS, "of_layers": 27,
                   "params": n_params, "batch": FAMILY_GRAD_BATCH,
                   "seq": FAMILY_GRAD_SEQ, "walls_s": walls,
                   "peak_mem_gb": peak, "loss": loss,
                   "aux": aux,
                   "router_grad_max": router, "card": smi}
    log(f"[family-grad] deepseek-v2-lite {FAMILY_GRAD_LAYERS}/27 layers, "
        f"{n_params / 1e9:.3f}B params, bf16, batch {FAMILY_GRAD_BATCH} x "
        f"{FAMILY_GRAD_SEQ}: forward + backward {walls[-1]:.3f} s (first "
        f"{walls[0]:.3f}), peak {peak:.2f} GB, loss {loss:.4f}, aux "
        f"{aux:.4f}, every gradient finite, router "
        f"|g| max {router:.3g} | {smi}")
    del params, grads, g, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out, total


def _family_model_agreement(torch):
    """20e: the three smoke configs in float32 on the card and on the
    CPU, the same params and tokens: prefill logits by the dense (64
    tokens) and streaming (2,048) attention paths, the MoE configs by both
    dispatch modes (einsum in chunks of FAMILY_AGREE_CHUNK tokens, the
    last padded); FAMILY_AGREE_DECODE_STEPS teacher-forced decode steps,
    past gemma3's 16-slot local rings and past the end of deepseek's
    FAMILY_AGREE_MLA_SLOTS-slot latent cache (the clamp); each within
    DENSE_AGREE_LIMIT of the largest CPU logit.  Planted faults: gemma3's
    local rings as long as the sequence, and deepseek's latent cache long
    enough that it never clamps, must each fail it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm

    worst, planted, by_arch = 0.0, {}, {}
    gen = torch.Generator().manual_seed(11)
    steps, B = FAMILY_AGREE_DECODE_STEPS, 2
    for arch in FAMILY_ARCHS:
        base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = init_params(base, 0, device="cpu")
        dev_params = tree.map_leaves(lambda p: p.to("cuda"), params)
        errs = {}
        modes = ("gather", "einsum") if base.num_experts else (None,)
        for mode in modes:
            cfg = dataclasses.replace(
                base, moe_dispatch=mode,
                moe_chunk=FAMILY_AGREE_CHUNK) if mode == "einsum" else base
            for name, shape in (("prefill_dense", (2, 64)),
                                ("prefill_streaming",
                                 (1, DENSE_AGREE_STREAM_SEQ))):
                tok = torch.randint(1, cfg.vocab_size, shape, generator=gen)
                want = S.prefill_logits(cfg, params, tok)
                errs[f"{name}/{mode or 'dense'}"] = _rel_gap(
                    S.prefill_logits(cfg, dev_params, tok.to("cuda")), want)
        slots = FAMILY_AGREE_MLA_SLOTS if base.use_mla else steps
        tok = torch.randint(1, base.vocab_size, (B, steps), generator=gen)
        caches = {d: lm.init_cache(base, B, slots, device=d)
                  for d in ("cpu", "cuda")}
        fault_cfg, fault_cache = base, None
        if base.global_every:
            fault_cfg = dataclasses.replace(base, sliding_window=steps)
        if base.global_every or base.use_mla:
            fault_cache = lm.init_cache(fault_cfg, B, steps, device="cuda")
        err = fault = 0.0
        with torch.inference_mode():
            for t in range(steps):
                want, _ = lm.decode_step(base, params, caches["cpu"],
                                         tok[:, t], t)
                got, _ = lm.decode_step(base, dev_params, caches["cuda"],
                                        tok[:, t].to("cuda"), t)
                err = max(err, _rel_gap(got, want))
                if fault_cache is not None:
                    bad, _ = lm.decode_step(fault_cfg, dev_params,
                                            fault_cache,
                                            tok[:, t].to("cuda"), t)
                    fault = max(fault, _rel_gap(bad, want))
        errs["decode"] = err
        if base.global_every:
            planted["gemma3 local rings as long as the sequence"] = fault
        elif base.use_mla:
            planted["deepseek latent cache that never clamps"] = fault
        by_arch[arch] = errs
        worst = max([worst] + list(errs.values()))
    if not worst <= DENSE_AGREE_LIMIT:
        raise AssertionError(f"[family-agree] card and CPU logits differ: "
                             f"{by_arch} (limit {DENSE_AGREE_LIMIT})")
    missed = {k: v for k, v in planted.items() if not v > DENSE_AGREE_LIMIT}
    if len(planted) != 2 or missed:
        raise AssertionError(f"[family-agree] planted faults pass the gate: "
                             f"{planted}")
    log(f"[family-agree] smoke gemma3 / phi3.5-moe / deepseek f32, card vs "
        f"CPU (dense and streaming prefill, both dispatch modes, {steps} "
        f"decode steps past the rings' wrap and the latent cache's end): "
        f"worst {worst:.3g} of max |logit| (limit {DENSE_AGREE_LIMIT}); "
        f"planted {planted}")
    return {"worst": worst, "by_arch": by_arch, "planted": planted}


def _family_trainer_agreement(torch):
    """20e: the three smoke configs in float32 trained on the card
    (kernel 3) and on the CPU (plain) with the same CPU-drawn masks and
    batches, DASHA-MVR, DENSE_AGREE_ROUNDS rounds, SGD server: the states
    within DENSE_AGREE_LIMIT of each leaf's largest magnitude.  Planted
    fault: the card run on the next round's masks must fail it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches)
    from repro_torch.models import init_params
    from repro_torch.optim.distributed import DashaTrainConfig

    n, rounds = TRAIN_NODES, DENSE_AGREE_ROUNDS
    dcfg = DashaTrainConfig(gamma=0.05, compression=0.25, variant="mvr",
                            b=0.1, n_nodes=n, server_opt="sgd")
    errs, planted = {}, {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
        batches = [make_node_batches(t, text, n, 2, device="cpu")
                   for t in range(rounds)]
        params = init_params(cfg, 0, device="cpu")
        draws = _replay_draws(torch, params, dcfg, rounds)
        cpu, _ = _replayed_trainer(torch, cfg, dcfg, params, batches, draws,
                                   "cpu", False)
        card, _ = _replayed_trainer(torch, cfg, dcfg, params, batches,
                                    draws, "cuda", True)
        try:
            errs[arch] = _states_agree(torch, card, cpu, DENSE_AGREE_LIMIT)
        except AssertionError as e:
            raise AssertionError(f"[family-agree] trainer {arch}: {e}") \
                from None
        if arch == FAMILY_ARCHS[-1]:
            shifted, _ = _replayed_trainer(torch, cfg, dcfg, params,
                                           batches, draws, "cuda", True, 1)
            try:
                _states_agree(torch, shifted, cpu, DENSE_AGREE_LIMIT)
            except AssertionError as e:
                planted[f"{arch} on the next round's masks"] = str(e)[:120]
            else:
                raise AssertionError(f"[family-agree] {arch} on the next "
                                     "round's masks passes the state gate")
    worst = max(errs.values())
    log(f"[family-agree] trainer, smoke gemma3 / phi3.5-moe / deepseek "
        f"f32, mvr with kernel 3 on the card against the CPU, {rounds} "
        f"rounds with injected CPU masks and batches: worst {worst:.3g} of "
        f"a leaf's largest magnitude (limit {DENSE_AGREE_LIMIT}); planted "
        f"faults caught: {sorted(planted)}")
    return {"worst": worst, "by_arch": errs, "planted": planted}


def phase_family(torch, smi: str):
    """Phase 20: gemma3-12b, deepseek-v2-lite-16b and phi3.5-moe served at
    full width (the first two at full depth), the three smoke configs
    trained with kernel 3, deepseek's routed backward at full width, and
    card against CPU.  Returns the report and kernel 3's launches on the
    trainers."""
    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    log(f"[family] before the phase: {held['allocated_gb']:.2f} GB "
        f"allocated, {held['reserved_gb']:.2f} GB reserved; cuts: "
        f"{FAMILY_CUTS}")
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        walls[name] = time.perf_counter() - t1
        log(f"[family] {name} in {walls[name]:.1f} s")
        return res

    trainer, k3 = part("trainer", _family_trainer, smi)
    serving = {run[0]: part(f"serve {run[0]}", _family_serve, smi, *run)
               for run in FAMILY_RUNS}
    agree = part("agreement", _family_model_agreement)
    train_agree = part("trainer_agreement", _family_trainer_agreement)
    wall = time.perf_counter() - t0
    log(f"[family] phase 20 in {wall:.1f} s")
    return {"held_before": held, "trainer": trainer, "serve": serving,
            "agreement": agree, "trainer_agreement": train_agree,
            "cuts": FAMILY_CUTS, "wall_s": wall, "walls_s": walls,
            "nvidia_smi": smi}, k3


# ---------------------------------------------------------------------------
# phase 21: the hybrid family (zamba2-1.2b: Mamba2 layers and one shared
# transformer block)
# ---------------------------------------------------------------------------

def _hybrid_uses(cfg) -> int:
    """Uses of the shared block: one before every hybrid_attn_every-th
    layer."""
    return -(-cfg.num_layers // cfg.hybrid_attn_every)


def _hybrid_ssd_shape(cfg, batch: int, seq: int):
    return (batch, seq, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
            min(cfg.ssd_chunk, seq))


def _numel(params) -> float:
    from repro_torch.core import tree
    return float(sum(w.numel() for w in tree.leaves(params)))


def hybrid_prefill_bound(cfg, params, batch: int, seq: int):
    """The least time of a last-position prefill: the bf16 tensor-core
    operations of every token through the Mamba2 layers' weights and the
    shared block's at each of its uses, each layer's SSD (the intra-chunk
    work of :func:`ssd_bound` and the chunk states' output, 2 N P H a
    token), each use's causal attention over the keys each query sees, and
    the tied head at the last position; against reading the weights once.
    Returns ((ms, by), flops)."""
    tokens = batch * seq
    uses = _hybrid_uses(cfg)
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    _, ssd_flops, _ = ssd_bound(_hybrid_ssd_shape(cfg, batch, seq), 2)
    flops = (2 * (_numel(params["layers"])
                  + uses * _numel(params["shared_attn"])) * tokens
             + cfg.num_layers * (ssd_flops + 2 * N * P * H * tokens)
             + uses * 4.0 * cfg.head_dim * cfg.num_heads * batch
             * seq * (seq + 1) / 2
             + 2 * batch * cfg.d_model * cfg.padded_vocab)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = 2 * _numel(params) / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")), flops


def hybrid_decode_bound(cfg, params, cache, batch: int, t_mean: float):
    """The least time of one decode step at position ~``t_mean``: read the
    weights once (the tied embedding whole: it is the head), each use's K
    and V up to the position and write one slot, read and write the SSM
    states and conv windows; its bf16 operations beside it.  Returns
    ((ms, by), bytes)."""
    uses = _hybrid_uses(cfg)
    slot = 2 * cfg.num_kv_heads * cfg.head_dim * 2             # K and V
    mamba = cache["mamba"]
    state = sum(c.numel() * c.element_size() for c in mamba.values())
    nbytes = (2 * _numel(params)
              + uses * batch * (t_mean + 2) * slot + 2 * state)
    flops = (2 * (_numel(params["layers"])
                  + uses * _numel(params["shared_attn"])
                  + cfg.padded_vocab * cfg.d_model) * batch
             + uses * 4.0 * cfg.head_dim * cfg.num_heads * (t_mean + 1)
             * batch)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else
            (t_ops, "operations")), nbytes


def _hybrid_cut(cfg, params, layers: int):
    """``cfg`` and ``params`` cut to the first ``layers`` Mamba2 layers
    (the shared block unchanged)."""
    from repro_torch.core import tree
    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, layers=tree.map_leaves(lambda w: w[:layers],
                                                params["layers"])))


def _hybrid_prefill(torch, smi: str, cfg, params):
    """21a: one warm-up and HYBRID_PREFILL_TIMED timed ``prefill_logits``
    calls, each gated on kernel 5 launching once per Mamba2 layer and no
    other kernel launching; then a call cut to HYBRID_PROFILED_LAYERS
    layers under the profiler.  Returns the report and kernel 5's
    launches on the timed path."""
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.launch import serve as S

    B, T, L = HYBRID_PREFILL_BATCH, HYBRID_PREFILL_SEQ, cfg.num_layers
    tokens = make_lm_batch(1, SyntheticTextConfig(vocab_size=cfg.vocab_size,
                                                  seq_len=T), B,
                           device="cuda")["tokens"]
    walls, launches = [], 0
    for i in range(1 + HYBRID_PREFILL_TIMED):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        counts = _launch_counts()
        _gate_launches(f"hybrid prefill call {i}", counts, {"ssd_chunk": L})
        launches += counts["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[hybrid] prefill logits "
                             f"{tuple(logits.shape)} misshapen or not finite")
    (b_ms, by), flops = hybrid_prefill_bound(cfg, params, B, T)
    wall = sum(walls) / len(walls)

    n = HYBRID_PROFILED_LAYERS
    cut, cut_params = _hybrid_cut(cfg, params, n)
    t0 = time.perf_counter()
    table, pwall = profiled(torch, lambda: S.prefill_logits(
        cut, cut_params, tokens))
    with_tables = time.perf_counter() - t0
    busy_s = sum(t for _, t in table.values()) / 1e6
    k_count = sum(c for k, (c, _) in table.items() if "ssd_chunk_kernel" in k)
    k_ms = sum(t for k, (_, t) in table.items()
               if "ssd_chunk_kernel" in k) / 1e3
    if k_count != n:
        log(f"[hybrid] the profiled prefill recorded {k_count} ssd_chunk "
            f"launches, not {n}: no device time for it")
        k_ms = None
    layer = _hybrid_ssd_shape(cfg, B, T)
    _, _, k_bytes = ssd_bound(layer, 2)
    k_bytes_ms = k_bytes / HBM_BYTES_PER_S * 1e3
    (tc_ms, tc_by), _, _ = ssd_tc_bound(layer, 2)
    out = {"batch": B, "seq": T, "walls_s": walls,
           "tokens_per_s": B * T / wall, "peak_mem_gb": peak / 1e9,
           "bound_ms": b_ms, "bound_by": by, "flops": flops,
           "flops_per_token": flops / (B * T),
           "bound_share": b_ms / (wall * 1e3),
           "ssd_chunk_launches": launches,
           "ssd_chunk_launches_per_call": L,
           "profile": {"layers": n, "wall_s": pwall,
                       "with_tables_s": with_tables,
                       "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                       "launches": sum(c for c, _ in table.values()),
                       "ssd_chunk_launches": k_count,
                       "ssd_chunk_device_ms_per_layer":
                           None if k_ms is None else k_ms / n,
                       "ssd_chunk_bytes_bound_ms_per_layer": k_bytes_ms,
                       "ssd_chunk_tc_bound_ms_per_layer": tc_ms,
                       "ssd_chunk_tc_bound_by": tc_by,
                       "top_kernels": _top(table, 12)}}
    prof = out["profile"]
    log(f"[hybrid] prefill {B} x {T} at {L}/{L} layers in {walls} s, "
        f"{B * T / wall:.0f} tokens/s, peak {peak / 1e9:.2f} GB, bound "
        f"{b_ms:.1f} ms ({by}, {flops / (B * T) / 1e9:.2f} GFLOP a token, "
        f"{out['bound_share']:.3f} of it); ssd_chunk {launches} launches "
        f"({L} a call); profiled call of {n} layers {pwall:.3f} s, device "
        f"busy {prof['busy_share']:.3f}, ssd_chunk "
        f"{prof['ssd_chunk_device_ms_per_layer']} ms a layer vs a "
        f"{k_bytes_ms:.3f} ms bytes bound | {smi}")
    for k, c, ms in prof["top_kernels"]:
        log(f"[hybrid]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens
    torch.cuda.empty_cache()
    return out, launches


def _hybrid_serve(torch, smi: str):
    """21a-c: zamba2-1.2b at full width and depth in bf16 through
    ``prefill_logits`` (kernel 5 on every Mamba2 layer), ``serve`` for one
    request batch and decode steps on a long cache, none of which may
    launch a kernel but kernel 5 in the prefill.  Returns the report and
    kernel 5's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = get_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = _numel(params)
    out = {"arch": HYBRID_ARCH, "layers": cfg.num_layers,
           "shared_block_uses": _hybrid_uses(cfg), "params": int(n_params),
           "params_gb": 2 * n_params / 1e9,
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi}
    log(f"[hybrid] {cfg.num_layers} layers, {_hybrid_uses(cfg)} uses of the "
        f"shared block, {n_params / 1e9:.3f}B params "
        f"({2 * n_params / 1e9:.2f} GB bf16) in {out['init_s']:.1f} s")
    walls = out["walls_s"] = {}
    t0 = time.perf_counter()
    out["prefill"], launches = _hybrid_prefill(torch, smi, cfg, params)
    walls["prefill"] = time.perf_counter() - t0

    _reset_launch_counts()
    t0 = time.perf_counter()
    args = S.build_parser().parse_args([
        "--arch", HYBRID_ARCH, "--batch", str(HYBRID_SERVE_BATCH),
        "--prompt-len", str(HYBRID_SERVE_PROMPT), "--new-tokens",
        str(HYBRID_SERVE_NEW)])
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    if res.tokens.shape != (HYBRID_SERVE_BATCH, HYBRID_SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"[hybrid] serve tokens {res.tokens.shape} "
                             "misshapen or out of the vocabulary")
    out["serve"] = {"batch": HYBRID_SERVE_BATCH,
                    "prompt": HYBRID_SERVE_PROMPT, "new": HYBRID_SERVE_NEW,
                    "prompt_ms_per_step":
                        res.prefill_s / HYBRID_SERVE_PROMPT * 1e3,
                    "decode_ms_per_step":
                        res.decode_s / HYBRID_SERVE_NEW * 1e3,
                    "first_row": res.tokens[0].tolist()}
    del res
    walls["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = HYBRID_DECODE_BATCH
    out["decode"] = _family_decode(
        torch, smi, cfg, params, batch, "hybrid", HYBRID_DECODE_T0,
        lambda cache, t: hybrid_decode_bound(cfg, params, cache, batch, t))
    walls["decode"] = time.perf_counter() - t0
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[hybrid] serve and decode launched "
                             f"hand-written kernels: {counts}")
    out["serve_decode_launches"] = counts
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _hybrid_trainer(torch, smi: str):
    """21f: ``launch.train.train`` at ``zamba2-smoke`` (bf16), DASHA-MVR
    with kernel 3, gated on one launch per parameter leaf a round and
    nothing else; then one ``lm.loss_fn`` forward and backward at full
    width cut to HYBRID_GRAD_LAYERS layers in bf16, gated on finite
    gradients and a non-zero gradient of the shared block (the sum over
    its two uses).  Returns the report and kernel 3's launches."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, lm

    cfg = get_smoke_config(HYBRID_ARCH)
    args = _train_args(["--arch", HYBRID_ARCH, "--steps",
                        str(HYBRID_TRAIN_ROUNDS), "--log-every",
                        str(HYBRID_TRAIN_ROUNDS // 2), "--variant", "mvr",
                        "--use-kernel"])
    _reset_launch_counts()
    res = train(cfg, args, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = _launch_counts()
    leaves = len(tree.leaves(res.state.x))
    if leaves != HYBRID_LEAVES:
        raise AssertionError(f"[hybrid-train] {leaves} parameter leaves, "
                             f"expected {HYBRID_LEAVES}")
    _gate_launches("hybrid-train", counts, {
        "dasha_mvr_update": leaves * HYBRID_TRAIN_ROUNDS})
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses):
        raise AssertionError(f"[hybrid-train] eval loss {res.loss0} -> "
                             f"{losses}")
    out = {"config": cfg.name, "params": res.n_params, "leaves": leaves,
           "rounds": HYBRID_TRAIN_ROUNDS, "launches": counts,
           "eval_loss_start": res.loss0, "eval_loss_end": losses[-1],
           "seconds": [c["seconds"] for c in res.chunks]}
    del res

    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              num_layers=HYBRID_GRAD_LAYERS)
    params = init_params(cfg, 0, device="cuda")
    for w in tree.leaves(params):
        w.requires_grad_(True)
    batch = make_lm_batch(3, SyntheticTextConfig(
        vocab_size=cfg.vocab_size, seq_len=HYBRID_GRAD_SEQ),
        HYBRID_GRAD_BATCH, device="cuda")
    walls = []
    for _ in range(2):                              # warm-up, then timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    g = dict(zip([p for p, _ in tree.items(params)], grads))
    bad = [p for p, v in g.items() if not bool(torch.isfinite(v).all())]
    shared = max(float(v.abs().max()) for p, v in g.items()
                 if p.startswith("shared_attn/"))
    loss = float(loss.detach())
    if bad or not shared > 0 or not math.isfinite(loss):
        raise AssertionError(f"[hybrid-grad] loss {loss}, gradients not "
                             f"finite: {bad}, shared block |g| max {shared}")
    n_params = _numel(params)
    out["grad"] = {"arch": HYBRID_ARCH, "layers": HYBRID_GRAD_LAYERS,
                   "of_layers": 38, "shared_block_uses": _hybrid_uses(cfg),
                   "params": int(n_params), "batch": HYBRID_GRAD_BATCH,
                   "seq": HYBRID_GRAD_SEQ, "walls_s": walls,
                   "peak_mem_gb": peak, "loss": loss,
                   "shared_grad_max": shared, "card": smi}
    log(f"[hybrid-grad] {HYBRID_ARCH} {HYBRID_GRAD_LAYERS}/38 layers "
        f"({_hybrid_uses(cfg)} uses of the shared block), "
        f"{n_params / 1e9:.3f}B params, bf16, batch {HYBRID_GRAD_BATCH} x "
        f"{HYBRID_GRAD_SEQ}: forward + backward {walls[-1]:.3f} s (first "
        f"{walls[0]:.3f}), peak {peak:.2f} GB, loss {loss:.4f}, every "
        f"gradient finite, shared block |g| max {shared:.3g} | {smi}")
    del params, grads, g, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts["dasha_mvr_update"]


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """``obj.name`` replaced by ``value`` (a planted fault) inside the
    block."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def _hybrid_model_agreement(torch):
    """21e: ``zamba2-smoke`` in float32 on the card and on the CPU, the
    same params and tokens: prefill logits at 64 and 2,048 tokens (the
    dense and the streaming attention; kernel 5 once per layer on the
    card, the plain version on the CPU) and HYBRID_AGREE_STEPS
    teacher-forced decode steps, each within DENSE_AGREE_LIMIT of the
    largest CPU logit.  Planted faults that must fail it: the shared block
    before the last layer of each period (``idx % every == every - 1``),
    and, from the middle of the decode on a copy of the card's cache, each
    use reading and writing the next use's K/V cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm

    cfg = dataclasses.replace(get_smoke_config(HYBRID_ARCH), dtype="float32")
    every, uses = cfg.hybrid_attn_every, _hybrid_uses(cfg)
    params = init_params(cfg, 0, device="cpu")
    dev_params = tree.map_leaves(lambda p: p.to("cuda"), params)
    gen = torch.Generator().manual_seed(13)
    errs, planted = {}, {}
    for name, shape in (("prefill_dense", (2, 64)),
                        ("prefill_streaming", (1, DENSE_AGREE_STREAM_SEQ))):
        tok = torch.randint(1, cfg.vocab_size, shape, generator=gen)
        want = S.prefill_logits(cfg, params, tok)
        _reset_launch_counts()
        got = S.prefill_logits(cfg, dev_params, tok.to("cuda"))
        _gate_launches(f"hybrid-agree {name}", _launch_counts(),
                       {"ssd_chunk": cfg.num_layers})
        errs[name] = _rel_gap(got, want)
        if name == "prefill_dense":
            with _patched(lm, "_hybrid_slot", lambda c, idx: idx // every
                          if idx % every == every - 1 else None):
                planted["shared block at idx % every == every - 1"] = \
                    _rel_gap(S.prefill_logits(cfg, dev_params,
                                              tok.to("cuda")), want)
    B, steps = 2, HYBRID_AGREE_STEPS
    tok = torch.randint(1, cfg.vocab_size, (B, steps), generator=gen)
    caches = {d: lm.init_cache(cfg, B, steps, device=d)
              for d in ("cpu", "cuda")}
    err = fault = 0.0
    shifted = None
    with torch.inference_mode():
        for t in range(steps):
            want, _ = lm.decode_step(cfg, params, caches["cpu"], tok[:, t], t)
            got, _ = lm.decode_step(cfg, dev_params, caches["cuda"],
                                    tok[:, t].to("cuda"), t)
            err = max(err, _rel_gap(got, want))
            if shifted is not None:
                with _patched(lm, "_hybrid_slot", lambda c, idx: (
                        idx // every + 1) % uses if idx % every == 0
                        else None):
                    bad, _ = lm.decode_step(cfg, dev_params, shifted,
                                            tok[:, t].to("cuda"), t)
                fault = max(fault, _rel_gap(bad, want))
            if t == steps // 2 - 1:
                shifted = tree.map_leaves(lambda c: c.clone(),
                                          caches["cuda"])
    errs["decode"] = err
    planted["decode on the next use's K/V cache"] = fault
    worst = max(errs.values())
    if not worst <= DENSE_AGREE_LIMIT:
        raise AssertionError(f"[hybrid-agree] card and CPU logits differ: "
                             f"{errs} (limit {DENSE_AGREE_LIMIT})")
    missed = {k: v for k, v in planted.items() if not v > DENSE_AGREE_LIMIT}
    if missed:
        raise AssertionError(f"[hybrid-agree] planted faults pass the gate: "
                             f"{planted}")
    log(f"[hybrid-agree] zamba2-smoke f32, card (kernel 5) vs CPU (dense "
        f"and streaming prefill, {steps} decode steps): worst {worst:.3g} "
        f"of max |logit| (limit {DENSE_AGREE_LIMIT}); planted {planted}")
    return {"worst": worst, "errors": errs, "planted": planted}


def _hybrid_trainer_agreement(torch):
    """21e: ``zamba2-smoke`` in float32 trained on the card, with kernel 3
    off and on, and on the CPU (plain), on the same CPU-drawn masks and
    batches, DASHA-MVR, DENSE_AGREE_ROUNDS rounds, SGD server: the states
    within DENSE_AGREE_LIMIT of each leaf's largest magnitude, or within
    HYBRID_CONTROL_FACTOR times the control (the CPU run from parameters
    nudged by half a float32 ulp, against the CPU run), whichever is
    larger.  Planted fault: the card run on the next round's masks must
    fail it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches)
    from repro_torch.models import init_params
    from repro_torch.optim.distributed import DashaTrainConfig

    n, rounds = TRAIN_NODES, DENSE_AGREE_ROUNDS
    dcfg = DashaTrainConfig(gamma=0.05, compression=0.25, variant="mvr",
                            b=0.1, n_nodes=n, server_opt="sgd")
    cfg = dataclasses.replace(get_smoke_config(HYBRID_ARCH), dtype="float32")
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batches = [make_node_batches(t, text, n, 2, device="cpu")
               for t in range(rounds)]
    params = init_params(cfg, 0, device="cpu")
    draws = _replay_draws(torch, params, dcfg, rounds)
    cpu, _ = _replayed_trainer(torch, cfg, dcfg, params, batches, draws,
                               "cpu", False)
    gen = torch.Generator().manual_seed(1)
    nudged, _ = _replayed_trainer(torch, cfg, dcfg, tree.map_leaves(
        lambda w: w * (1 + HALF_ULP_F32 * torch.randn(w.shape,
                                                      generator=gen)),
        params), batches, draws, "cpu", False)
    control = _states_agree(torch, nudged, cpu, math.inf)
    limit = max(DENSE_AGREE_LIMIT, HYBRID_CONTROL_FACTOR * control)
    errs = {}
    for use_kernel in (False, True):
        card, counts = _replayed_trainer(torch, cfg, dcfg, params, batches,
                                         draws, "cuda", use_kernel)
        _gate_launches(f"hybrid-agree trainer kernel {use_kernel}", counts,
                       {"dasha_mvr_update": HYBRID_LEAVES * rounds
                        if use_kernel else 0})
        try:
            errs[f"kernel_{'on' if use_kernel else 'off'}"] = _states_agree(
                torch, card, cpu, limit)
        except AssertionError as e:
            raise AssertionError(f"[hybrid-agree] trainer, kernel "
                                 f"{use_kernel}: {e}") from None
    shifted, _ = _replayed_trainer(torch, cfg, dcfg, params, batches, draws,
                                   "cuda", True, 1)
    try:
        _states_agree(torch, shifted, cpu, limit)
    except AssertionError as e:
        planted = {"the next round's masks": str(e)[:120]}
    else:
        raise AssertionError("[hybrid-agree] the card trainer on the next "
                             "round's masks passes the state gate")
    worst = max(errs.values())
    log(f"[hybrid-agree] trainer, zamba2-smoke f32, mvr on the card (kernel "
        f"3 off and on) against the CPU, {rounds} rounds with injected CPU "
        f"masks and batches: worst {worst:.3g} of a leaf's largest "
        f"magnitude (limit {limit:.3g}: the CPU's own spread under a "
        f"half-ulp nudge {control:.3g}); planted faults caught: {planted}")
    return {"worst": worst, "by_route": errs, "control": control,
            "limit": limit, "planted": planted}


def phase_hybrid(torch, smi: str):
    """Phase 21: zamba2-1.2b served at full width and depth (kernel 5 on
    its Mamba2 prefill), kernel 5 at its SSD shape, the smoke config
    trained with kernel 3, the full-width backward at 7 layers, and card
    against CPU.  Returns the report, the launches of kernels 5 and 3 on
    its paths, and kernel 5's row at zamba2's shape."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "free_gb": free / 1e9, "total_gb": total / 1e9}
    log(f"[hybrid] before the phase: {held['allocated_gb']:.2f} GB "
        f"allocated, {held['reserved_gb']:.2f} GB reserved, "
        f"{held['free_gb']:.2f} of {held['total_gb']:.2f} GB free; cuts: "
        f"{HYBRID_CUTS}")
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        walls[name] = time.perf_counter() - t1
        log(f"[hybrid] {name} in {walls[name]:.1f} s")
        return res

    ssd_rows = part("kernel5", phase_ssd_kernel, smi, [HYBRID_SSD_SHAPE],
                    (torch.bfloat16,))
    serving, k5 = part("serve", _hybrid_serve, smi)
    trainer, k3 = part("trainer", _hybrid_trainer, smi)
    agree = part("agreement", _hybrid_model_agreement)
    train_agree = part("trainer_agreement", _hybrid_trainer_agreement)
    wall = time.perf_counter() - t0
    log(f"[hybrid] phase 21 in {wall:.1f} s")
    return ({"held_before": held, "ssd_chunk_rows": ssd_rows,
             "serve": serving, "trainer": trainer, "agreement": agree,
             "trainer_agreement": train_agree, "cuts": HYBRID_CUTS,
             "wall_s": wall, "walls_s": walls, "nvidia_smi": smi},
            {"ssd_chunk": k5, "dasha_mvr_update": k3}, ssd_rows)


def _cross_n(cfg) -> int:
    """Cross blocks: one per cross_attn_every layers (VLM), one per
    decoder layer (whisper)."""
    if cfg.arch_type == "vlm":
        return cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers


def _cross_kv_weights(params) -> float:
    """The cross blocks' K and V projections: run once a prefill per
    image token (and never in decode, which reads the cross K/V)."""
    attn = params["cross_layers"]["attn"]
    return float(attn["wk"].numel() + attn["wv"].numel())


def _gate_cross_blocks(params):
    """Every cross block's gates set to CROSS_GATES in place (they
    start at zero, where a cross block adds nothing)."""
    for name, value in zip(("attn_gate", "mlp_gate"), CROSS_GATES):
        params["cross_layers"][name].fill_(value)
    return params


def cross_prefill_bound(cfg, params, batch: int, seq: int, n_img: int,
                        n_params: int):
    """The least time of the VLM's last-position prefill: the bf16
    tensor-core operations of every token through the self layers and
    the cross blocks' query side (q, o, the MLP), of every image token
    through the cross K and V projections, each layer's causal attention
    over the keys each query sees, each cross block's attention over
    every image token, and the head at the last position; against
    reading the weights once.  Returns ((ms, by), flops)."""
    tokens = batch * seq
    kv_w = _cross_kv_weights(params)
    per_key = 4.0 * cfg.head_dim * cfg.num_heads
    flops = (2 * _numel(params["layers"]) * tokens
             + 2 * (_numel(params["cross_layers"]) - kv_w) * tokens
             + 2 * kv_w * batch * n_img
             + cfg.num_layers * per_key * batch * seq * (seq + 1) / 2
             + _cross_n(cfg) * per_key * tokens * n_img
             + 2 * batch * cfg.d_model * cfg.padded_vocab)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = 2 * n_params / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")), flops


def cross_decode_bound(cfg, params, cache, batch: int, t_mean: float,
                       n_params: int):
    """The least time of one VLM decode step at position ~``t_mean``:
    read the weights once (the embedding only at the batch's rows; the
    cross K and V projections not at all: decode reads the cross K/V),
    the self K/V up to the position, write one slot, and read the image
    K/V once; its bf16 operations beside it.  Returns ((ms, by),
    bytes)."""
    embed = cfg.padded_vocab * cfg.d_model
    kv_w = _cross_kv_weights(params)
    slot = 2 * cfg.num_kv_heads * cfg.head_dim                  # K and V
    n_img = cache["cross"]["k"].shape[2]
    cross_bytes = sum(c.numel() * c.element_size()
                      for c in cache["cross"].values())
    nbytes = (2 * (n_params - embed - kv_w + batch * cfg.d_model)
              + 2 * slot * batch * cfg.num_layers * (t_mean + 2)
              + cross_bytes)
    per_key = 4.0 * cfg.head_dim * cfg.num_heads
    flops = (2 * (n_params - embed - kv_w + cfg.padded_vocab * cfg.d_model)
             * batch
             + cfg.num_layers * per_key * (t_mean + 1) * batch
             + _cross_n(cfg) * per_key * n_img * batch)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else
            (t_ops, "operations")), nbytes


def _cross_cut(cfg, params, layers: int):
    """The VLM cut to its first ``layers`` layers and the cross blocks
    they hold (5 layers: one cross block, after the fifth)."""
    from repro_torch.core import tree
    cut = dataclasses.replace(cfg, num_layers=layers)
    n = _cross_n(cut)
    return cut, dict(params, layers=tree.map_leaves(
        lambda w: w[:layers], params["layers"]),
        cross_layers=tree.map_leaves(lambda w: w[:n],
                                     params["cross_layers"]))


def _cross_prefill(torch, smi: str, cfg, params, n_params: int):
    """22a: one timed ``prefill_logits`` call of CROSS_PREFILL_BATCH x
    CROSS_PREFILL_SEQ tokens with the image tokens of each row, beside
    its bf16 bound, after a warm-up call cut to CROSS_PROFILED_LAYERS
    layers (one cross block: the same shapes a layer); then that cut
    call under the profiler, device activity only."""
    from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                           modality_kw)
    from repro_torch.launch import serve as S

    B, T = CROSS_PREFILL_BATCH, CROSS_PREFILL_SEQ
    batch = make_lm_batch(1, SyntheticTextConfig(vocab_size=cfg.vocab_size,
                                                 seq_len=T), B,
                          device="cuda", **modality_kw(cfg))
    tokens, img = batch["tokens"], batch["image_embeds"]
    n = CROSS_PROFILED_LAYERS
    cut, cut_params = _cross_cut(cfg, params, n)
    S.prefill_logits(cut, cut_params, tokens, image_embeds=img)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = S.prefill_logits(cfg, params, tokens, image_embeds=img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (B, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[cross] prefill logits {tuple(logits.shape)} "
                             "misshapen or not finite")
    n_img = cfg.num_image_tokens
    (b_ms, by), flops = cross_prefill_bound(cfg, params, B, T, n_img,
                                            n_params)
    t1 = time.perf_counter()
    table, pwall = profiled(torch, lambda: S.prefill_logits(
        cut, cut_params, tokens, image_embeds=img), cpu=False)
    busy_s = sum(t for _, t in table.values()) / 1e6
    out = {"batch": B, "seq": T, "image_tokens": n_img, "wall_s": wall,
           "tokens_per_s": B * T / wall, "peak_mem_gb": peak / 1e9,
           "bound_ms": b_ms, "bound_by": by, "flops": flops,
           "bound_share": b_ms / (wall * 1e3),
           "profile": {"layers": n, "cross_blocks": _cross_n(cut),
                       "wall_s": pwall,
                       "with_tables_s": time.perf_counter() - t1,
                       "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                       "launches": sum(c for c, _ in table.values()),
                       "top_kernels": _top(table, 10)}}
    log(f"[cross] prefill {B} x {T} with {n_img} image tokens a row in "
        f"{wall:.3f} s, {B * T / wall:.0f} tokens/s, peak {peak / 1e9:.2f} "
        f"GB, bound {b_ms:.1f} ms ({by}, {flops / 1e12:.1f} TFLOP at the "
        f"bf16 rate, {out['bound_share']:.3f} of it); a profiled call of {n} "
        f"layers ({_cross_n(cut)} cross block) {pwall:.3f} s, device busy "
        f"{busy_s / pwall:.3f} | {smi}")
    for k, c, ms in out["profile"]["top_kernels"]:
        log(f"[cross]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens, img, batch
    torch.cuda.empty_cache()
    return out


def _cross_vlm_serve(torch, smi: str):
    """22a: llama-3.2-vision-11b at full width in bf16, CROSS_SERVE_LAYERS
    of its 40 layers (4 of 8 cross blocks), gates at CROSS_GATES: the
    prefill, ``serve``
    for one request batch, and decode steps at CROSS_DECODE_BATCH on
    FAMILY_DECODE_SLOTS slots of random self K/V beside the image K/V of
    each cross block; no hand-written kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                           modality_kw)
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm

    cfg = dataclasses.replace(get_config(CROSS_VLM),
                              num_layers=CROSS_SERVE_LAYERS)
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _gate_cross_blocks(init_params(cfg, 0, device="cuda"))
    torch.cuda.synchronize()
    n_params = int(_numel(params))
    out = {"arch": CROSS_VLM, "layers": cfg.num_layers,
           "cross_blocks": _cross_n(cfg), "params": n_params,
           "params_gb": 2 * n_params / 1e9,
           "init_s": time.perf_counter() - t0, "gates": CROSS_GATES,
           "card": smi}
    log(f"[cross {CROSS_VLM}] {cfg.num_layers} layers, {_cross_n(cfg)} cross "
        f"blocks, {n_params / 1e9:.3f}B params ({2 * n_params / 1e9:.2f} GB "
        f"bf16) in {out['init_s']:.1f} s")
    walls = out["walls_s"] = {}
    t0 = time.perf_counter()
    out["prefill"] = _cross_prefill(torch, smi, cfg, params, n_params)
    walls["prefill"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    args = S.build_parser().parse_args([
        "--arch", CROSS_VLM, "--batch", str(CROSS_SERVE_BATCH),
        "--prompt-len", str(CROSS_SERVE_PROMPT), "--new-tokens",
        str(CROSS_SERVE_NEW)])
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    if res.tokens.shape != (CROSS_SERVE_BATCH, CROSS_SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"[cross] serve tokens {res.tokens.shape} "
                             "misshapen or out of the vocabulary")
    out["serve"] = {"batch": CROSS_SERVE_BATCH, "prompt": CROSS_SERVE_PROMPT,
                    "new": CROSS_SERVE_NEW,
                    "prompt_ms_per_step":
                        res.prefill_s / CROSS_SERVE_PROMPT * 1e3,
                    "decode_ms_per_step":
                        res.decode_s / CROSS_SERVE_NEW * 1e3,
                    "first_row": res.tokens[0].tolist()}
    del res
    walls["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    batch = CROSS_DECODE_BATCH
    img = make_lm_batch(2, SyntheticTextConfig(vocab_size=cfg.vocab_size,
                                               seq_len=1), batch,
                        device="cuda", **modality_kw(cfg))["image_embeds"]
    image_kv = lm.make_image_kv(cfg, params, img, device="cuda")
    del img
    out["decode"] = _family_decode(
        torch, smi, cfg, params, batch, f"cross {CROSS_VLM}",
        FAMILY_DECODE_T0, lambda cache, t: cross_decode_bound(
            cfg, params, cache, batch, t, n_params), profile=False,
        cache_kw={"image_kv": image_kv})
    out["decode"]["image_kv_gb"] = sum(
        c.numel() * c.element_size() for c in image_kv.values()) / 1e9
    walls["decode"] = time.perf_counter() - t0
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[cross] serving launched hand-written "
                             f"kernels: {counts}")
    out["launches"] = counts
    del params, image_kv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cross_vlm_train(torch, smi: str):
    """22a: ``launch.train.train`` at the VLM's smoke config (bf16),
    DASHA-MVR with kernel 3 once per parameter leaf a round and nothing
    else; then one ``lm.loss_fn`` forward and backward at full width cut
    to CROSS_GRAD_LAYERS layers (one cross block, gates at CROSS_GATES)
    with the image tokens: every gradient finite, the gates' non-zero.
    Returns the report and kernel 3's launches."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                           modality_kw)
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, lm

    cfg = get_smoke_config(CROSS_VLM)
    args = _train_args(["--arch", CROSS_VLM, "--steps",
                        str(CROSS_TRAIN_ROUNDS), "--log-every",
                        str(CROSS_TRAIN_ROUNDS // 2), "--variant", "mvr",
                        "--use-kernel"])
    _reset_launch_counts()
    res = train(cfg, args, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = _launch_counts()
    leaves = len(tree.leaves(res.state.x))
    if leaves != CROSS_LEAVES[CROSS_VLM]:
        raise AssertionError(f"[cross-train] {leaves} parameter leaves, "
                             f"expected {CROSS_LEAVES[CROSS_VLM]}")
    _gate_launches("cross-train vlm smoke", counts, {
        "dasha_mvr_update": leaves * CROSS_TRAIN_ROUNDS})
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses):
        raise AssertionError(f"[cross-train] eval loss {res.loss0} -> "
                             f"{losses}")
    out = {"config": cfg.name, "params": res.n_params, "leaves": leaves,
           "rounds": CROSS_TRAIN_ROUNDS, "launches": counts,
           "eval_loss_start": res.loss0, "eval_loss_end": losses[-1],
           "seconds": [c["seconds"] for c in res.chunks]}
    del res

    cfg = dataclasses.replace(get_config(CROSS_VLM),
                              num_layers=CROSS_GRAD_LAYERS)
    params = _gate_cross_blocks(init_params(cfg, 0, device="cuda"))
    for w in tree.leaves(params):
        w.requires_grad_(True)
    batch = make_lm_batch(3, SyntheticTextConfig(
        vocab_size=cfg.vocab_size, seq_len=CROSS_GRAD_SEQ),
        CROSS_GRAD_BATCH, device="cuda", **modality_kw(cfg))
    walls = []
    for _ in range(2):                              # warm-up, then timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    g = dict(zip([p for p, _ in tree.items(params)], grads))
    bad = [p for p, v in g.items() if not bool(torch.isfinite(v).all())]
    gates = {p: float(g[f"cross_layers/{p}"].abs().max())
             for p in ("attn_gate", "mlp_gate")}
    cross_w = float(g["cross_layers/attn/wk"].abs().max())
    loss = float(loss.detach())
    if bad or not min(gates.values()) > 0 or not cross_w > 0 or \
            not math.isfinite(loss):
        raise AssertionError(f"[cross-grad] loss {loss}, gradients not "
                             f"finite: {bad}, gates |g| {gates}, cross wk "
                             f"|g| {cross_w}")
    n_params = _numel(params)
    out["grad"] = {"arch": CROSS_VLM, "layers": CROSS_GRAD_LAYERS,
                   "of_layers": 40, "cross_blocks": _cross_n(cfg),
                   "params": int(n_params), "batch": CROSS_GRAD_BATCH,
                   "seq": CROSS_GRAD_SEQ,
                   "image_tokens": cfg.num_image_tokens, "walls_s": walls,
                   "peak_mem_gb": peak, "loss": loss,
                   "gate_grad_max": gates, "cross_wk_grad_max": cross_w,
                   "card": smi}
    log(f"[cross-grad] {CROSS_VLM} {CROSS_GRAD_LAYERS}/40 layers "
        f"({_cross_n(cfg)} cross block), {n_params / 1e9:.3f}B params, bf16, "
        f"batch {CROSS_GRAD_BATCH} x {CROSS_GRAD_SEQ} with "
        f"{cfg.num_image_tokens} image tokens: forward + backward "
        f"{walls[-1]:.3f} s (first {walls[0]:.3f}), peak {peak:.2f} GB, loss "
        f"{loss:.4f}, every gradient finite, gates |g| {gates}, cross wk |g| "
        f"{cross_w:.3g} | {smi}")
    del params, grads, g, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts["dasha_mvr_update"]


def _cross_whisper(torch, smi: str):
    """22b: whisper-tiny at full width and depth: ``serve`` at
    WHISPER_SERVE_BATCH with its frames through the encoder, a
    WHISPER_SERVE_PROMPT-token prompt and WHISPER_SERVE_NEW new tokens
    (Whisper's 448 positions), no hand-written kernel launched; then
    ``launch.train.train`` at full width, n = 4 x 2 x WHISPER_TRAIN_SEQ
    tokens with the frames, DASHA-MVR with kernel 3 once per parameter
    leaf a round and nothing else, the peak reported.  Returns the report
    and kernel 3's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import init_params

    cfg = get_config(CROSS_AUDIO)
    params = _gate_cross_blocks(init_params(cfg, 0, device="cuda"))
    B, P, N = WHISPER_SERVE_BATCH, WHISPER_SERVE_PROMPT, WHISPER_SERVE_NEW
    args = S.build_parser().parse_args([
        "--arch", CROSS_AUDIO, "--batch", str(B), "--prompt-len", str(P),
        "--new-tokens", str(N)])
    _reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[cross-whisper] serving launched hand-written "
                             f"kernels: {counts}")
    if res.tokens.shape != (B, N) or res.state.t != P + N or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"[cross-whisper] serve tokens "
                             f"{res.tokens.shape} at t = {res.state.t} "
                             "misshapen or out of the vocabulary")
    serve = {"batch": B, "frames": cfg.num_audio_frames, "prompt": P,
             "new": N, "positions": P + N, "wall_s": wall,
             "prompt_ms_per_step": res.prefill_s / P * 1e3,
             "decode_ms_per_step": res.decode_s / N * 1e3,
             "decode_tokens_per_s": B * N / res.decode_s,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts, "first_row": res.tokens[0].tolist()}
    log(f"[cross-whisper] serve batch {B}, {cfg.num_audio_frames} frames "
        f"through the encoder, {P}-token prompt + {N} new ({P + N} "
        f"positions): {wall:.2f} s, prompt {serve['prompt_ms_per_step']:.2f} "
        f"ms a step, decode {serve['decode_ms_per_step']:.2f} ms a step "
        f"({serve['decode_tokens_per_s']:.0f} tokens/s), peak "
        f"{serve['peak_mem_gb']:.2f} GB, no kernel | {smi}")
    del res, params
    gc.collect()
    torch.cuda.empty_cache()

    rounds = WHISPER_TRAIN_WARMUP + WHISPER_TRAIN_ROUNDS
    targs = build_parser().parse_args([
        "--arch", CROSS_AUDIO, "--nodes", str(TRAIN_NODES), "--batch",
        str(TRAIN_BATCH), "--seq", str(WHISPER_TRAIN_SEQ), "--server-opt",
        "adam", "--steps", str(rounds), "--log-every",
        str(WHISPER_TRAIN_WARMUP), "--variant", "mvr", "--use-kernel"])
    _reset_launch_counts()
    res = train(cfg, targs, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = _launch_counts()
    leaves = len(tree.leaves(res.state.x))
    if leaves != CROSS_LEAVES[CROSS_AUDIO]:
        raise AssertionError(f"[cross-whisper] {leaves} parameter leaves, "
                             f"expected {CROSS_LEAVES[CROSS_AUDIO]}")
    _gate_launches("cross-whisper trainer", counts,
                   {"dasha_mvr_update": leaves * rounds})
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses):
        raise AssertionError(f"[cross-whisper] eval loss {res.loss0} -> "
                             f"{losses}")
    timed = res.chunks[1:]                      # the first chunk warms up
    twall = sum(c["seconds"] for c in timed)
    tokens = TRAIN_NODES * TRAIN_BATCH * WHISPER_TRAIN_SEQ
    trainer = {"arch": CROSS_AUDIO, "params": res.n_params, "leaves": leaves,
               "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
               "seq": WHISPER_TRAIN_SEQ, "frames": cfg.num_audio_frames,
               "rounds": rounds, "rounds_timed": WHISPER_TRAIN_ROUNDS,
               "rounds_per_s": WHISPER_TRAIN_ROUNDS / twall,
               "tokens_per_s": WHISPER_TRAIN_ROUNDS * tokens / twall,
               "peak_mem_gb": max(c["peak_mem_gb"] for c in res.chunks),
               "eval_loss_start": res.loss0, "eval_loss_end": losses[-1],
               "launches": counts, "chunks": res.chunks}
    log(f"[cross-whisper] trainer at full width ({res.n_params / 1e6:.2f}M "
        f"params, {leaves} leaves), n = {TRAIN_NODES} x {TRAIN_BATCH} x "
        f"{WHISPER_TRAIN_SEQ} tokens with {cfg.num_audio_frames} frames: "
        f"{trainer['rounds_per_s']:.3f} rounds/s, "
        f"{trainer['tokens_per_s']:.0f} tokens/s, peak "
        f"{trainer['peak_mem_gb']:.2f} GB, eval loss {res.loss0:.4f} -> "
        f"{losses[-1]:.4f}, launches {counts} | {smi}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve": serve, "trainer": trainer}, counts["dasha_mvr_update"]


def _bidirectional_encoder(torch):
    """A planted fault: the whisper encoder with every frame attending to
    every frame (the mask all-true inside ``lm._encoder_forward``; the
    reference's encoder attends causally)."""
    from repro_torch.models import attention, lm
    real = lm._encoder_forward

    def encoder(cfg, params, frames):
        with _patched(attention, "_causal_window_mask",
                      lambda q, k, w: torch.ones(
                          (q.shape[0], k.shape[0]), dtype=torch.bool,
                          device=q.device)):
            return real(cfg, params, frames)
    return _patched(lm, "_encoder_forward", encoder)


def _cross_smoke(torch, arch: str):
    """The float32 smoke config of ``arch``, its CPU params with gated
    cross blocks, and the modality keyword of its inputs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    key = "image_embeds" if cfg.arch_type == "vlm" else "frames"
    return cfg, _gate_cross_blocks(init_params(cfg, 0, device="cpu")), key


def _cross_model_agreement(torch):
    """22c: the two smoke configs in float32 with gated cross blocks, on
    the card and on the CPU, the same params, tokens and modality inputs:
    prefill logits (64 tokens) and CROSS_AGREE_STEPS teacher-forced decode
    steps on the cross K/V made by ``make_image_kv`` / ``make_enc_kv``,
    each within DENSE_AGREE_LIMIT of the largest CPU logit.  Planted
    faults that must fail it: the gates zeroed on the card, the VLM's
    cross block after ``idx % every == 0``, a bidirectional encoder."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import lm

    gen = torch.Generator().manual_seed(17)
    errs, planted = {}, {}
    for arch in (CROSS_VLM, CROSS_AUDIO):
        cfg, params, key = _cross_smoke(torch, arch)
        dev_params = tree.map_leaves(lambda p: p.to("cuda"), params)
        n_extra = cfg.num_image_tokens if key == "image_embeds" \
            else cfg.num_audio_frames
        B = 2
        tok = torch.randint(1, cfg.vocab_size, (B, 64), generator=gen)
        extra = torch.randn((B, n_extra, cfg.d_model), generator=gen)
        want = S.prefill_logits(cfg, params, tok, **{key: extra})

        def card(p=dev_params):
            return S.prefill_logits(cfg, p, tok.to("cuda"),
                                    **{key: extra.to("cuda")})
        _reset_launch_counts()
        errs[f"{arch} prefill"] = _rel_gap(card(), want)
        _gate_launches(f"cross-agree {arch} prefill", _launch_counts(), {})
        zeroed = dict(dev_params, cross_layers=dict(
            dev_params["cross_layers"], **{
                g: torch.zeros_like(dev_params["cross_layers"][g])
                for g in ("attn_gate", "mlp_gate")}))
        planted[f"{arch} gates zeroed"] = _rel_gap(card(zeroed), want)
        if key == "image_embeds":
            every = cfg.cross_attn_every
            with _patched(lm, "_cross_slot", lambda c, idx: idx // every
                          if idx % every == 0 else None):
                planted[f"{arch} cross block after idx % every == 0"] = \
                    _rel_gap(card(), want)
        else:
            with _bidirectional_encoder(torch):
                planted[f"{arch} bidirectional encoder"] = _rel_gap(card(),
                                                                    want)
        steps = CROSS_AGREE_STEPS
        tok = torch.randint(1, cfg.vocab_size, (B, steps), generator=gen)
        make = lm.make_image_kv if key == "image_embeds" else lm.make_enc_kv
        kw = "image_kv" if key == "image_embeds" else "enc_kv"
        with torch.inference_mode():
            caches = {d: lm.init_cache(cfg, B, steps, device=d, **{
                kw: make(cfg, p, extra, device=d)})
                for d, p in (("cpu", params), ("cuda", dev_params))}
            err = 0.0
            for t in range(steps):
                want, _ = lm.decode_step(cfg, params, caches["cpu"],
                                         tok[:, t], t)
                got, _ = lm.decode_step(cfg, dev_params, caches["cuda"],
                                        tok[:, t].to("cuda"), t)
                err = max(err, _rel_gap(got, want))
        errs[f"{arch} decode"] = err
    worst = max(errs.values())
    if not worst <= DENSE_AGREE_LIMIT:
        raise AssertionError(f"[cross-agree] card and CPU logits differ: "
                             f"{errs} (limit {DENSE_AGREE_LIMIT})")
    missed = {k: v for k, v in planted.items() if not v > DENSE_AGREE_LIMIT}
    if len(planted) != 4 or missed:
        raise AssertionError(f"[cross-agree] planted faults pass the gate: "
                             f"{planted}")
    log(f"[cross-agree] llama-vision-smoke and whisper-smoke f32, gates "
        f"{CROSS_GATES}, card vs CPU (prefill, {CROSS_AGREE_STEPS} decode "
        f"steps on the cross K/V): worst {worst:.3g} of max |logit| (limit "
        f"{DENSE_AGREE_LIMIT}); planted {planted}")
    return {"worst": worst, "errors": errs, "planted": planted}


def _cross_trainer_agreement(torch):
    """22c: the two smoke configs in float32 with gated cross blocks,
    trained on the card with kernel 3 and on the CPU (plain) on the same
    CPU-drawn masks and batches (image embeddings or frames included),
    DASHA-MVR, CROSS_AGREE_ROUNDS rounds, SGD server: the states within
    DENSE_AGREE_LIMIT of each leaf's largest magnitude, or, where the
    card misses that, within HYBRID_CONTROL_FACTOR times the CPU's own
    spread under a half-ulp nudge of the parameters (run only then).
    Planted fault: the card run on the next round's masks must fail the
    gate."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches, modality_kw)
    from repro_torch.optim.distributed import DashaTrainConfig

    n, rounds = TRAIN_NODES, CROSS_AGREE_ROUNDS
    dcfg = DashaTrainConfig(gamma=0.05, compression=0.25, variant="mvr",
                            b=0.1, n_nodes=n, server_opt="sgd")
    by_arch = {}
    for arch in (CROSS_VLM, CROSS_AUDIO):
        cfg, params, _ = _cross_smoke(torch, arch)
        text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
        batches = [make_node_batches(t, text, n, 2, device="cpu",
                                     **modality_kw(cfg))
                   for t in range(rounds)]
        draws = _replay_draws(torch, params, dcfg, rounds)
        cpu, _ = _replayed_trainer(torch, cfg, dcfg, params, batches, draws,
                                   "cpu", False)
        card, counts = _replayed_trainer(torch, cfg, dcfg, params, batches,
                                         draws, "cuda", True)
        _gate_launches(f"cross-agree {arch} trainer", counts, {
            "dasha_mvr_update": CROSS_LEAVES[arch] * rounds})
        err = _states_agree(torch, card, cpu, math.inf)
        control, limit = None, DENSE_AGREE_LIMIT
        if err > limit:         # the model's own spread decides (as 21e)
            gen = torch.Generator().manual_seed(1)
            nudged, _ = _replayed_trainer(torch, cfg, dcfg, tree.map_leaves(
                lambda w: w * (1 + HALF_ULP_F32 * torch.randn(
                    w.shape, generator=gen)), params), batches, draws,
                "cpu", False)
            control = _states_agree(torch, nudged, cpu, math.inf)
            limit = max(limit, HYBRID_CONTROL_FACTOR * control)
        try:
            _states_agree(torch, card, cpu, limit)
        except AssertionError as e:
            raise AssertionError(f"[cross-agree] {arch} trainer: {e}") \
                from None
        shifted, _ = _replayed_trainer(torch, cfg, dcfg, params, batches,
                                       draws, "cuda", True, 1)
        try:
            _states_agree(torch, shifted, cpu, limit)
        except AssertionError as e:
            fault = str(e)[:120]
        else:
            raise AssertionError(f"[cross-agree] {arch}: the card trainer on "
                                 "the next round's masks passes the state "
                                 "gate")
        by_arch[arch] = {"worst": err, "control": control, "limit": limit,
                         "planted": {"the next round's masks": fault}}
    worst = max(v["worst"] for v in by_arch.values())
    log(f"[cross-agree] trainers, smoke f32 with gated cross blocks, mvr with "
        f"kernel 3 on the card against the CPU, {rounds} rounds with injected "
        f"CPU masks and batches: {by_arch}")
    return {"worst": worst, "by_arch": by_arch}


def phase_cross(torch, smi: str):
    """Phase 22: the cross-attention families — llama-3.2-vision-11b
    served at full width and depth (prefill, serve, decode on its two
    caches), its smoke trainer and its full-width backward cut to 5
    layers; whisper-tiny served and trained at full width; card against
    CPU at both smoke configs.  Returns the report and kernel 3's
    launches on its trainers."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "free_gb": free / 1e9, "total_gb": total / 1e9}
    log(f"[cross] before the phase: {held['allocated_gb']:.2f} GB allocated, "
        f"{held['free_gb']:.2f} of {held['total_gb']:.2f} GB free; cuts: "
        f"{CROSS_CUTS}")
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        walls[name] = time.perf_counter() - t1
        log(f"[cross] {name} in {walls[name]:.1f} s")
        return res

    vlm = part("vlm_serve", _cross_vlm_serve, smi)
    vlm_train, k3_vlm = part("vlm_train", _cross_vlm_train, smi)
    whisper, k3_whisper = part("whisper", _cross_whisper, smi)
    agree = part("agreement", _cross_model_agreement)
    train_agree = part("trainer_agreement", _cross_trainer_agreement)
    wall = time.perf_counter() - t0
    log(f"[cross] phase 22 in {wall:.1f} s | {smi}")
    return ({"held_before": held, "vlm": vlm, "vlm_train": vlm_train,
             "whisper": whisper, "agreement": agree,
             "trainer_agreement": train_agree, "cuts": CROSS_CUTS,
             "wall_s": wall, "walls_s": walls, "nvidia_smi": smi},
            {"vlm_smoke_trainer": k3_vlm, "whisper_trainer": k3_whisper})


# ---------------------------------------------------------------------------
# phase 23: registry compressors on the tree substrate, new lanes, seed API
# ---------------------------------------------------------------------------

def _p23_fields_equal(torch, a, b, leaf=None):
    """The fields of two states whose tensors differ in any bit (``leaf``:
    the path of ``a``'s single leaf)."""
    from repro_torch.core import tree
    bad = []
    for f in ("x", "g", "g_local", "h_local"):
        va = getattr(a, f)
        va = tree.get(va, leaf) if leaf else va
        if not torch.equal(va, getattr(b, f)):
            bad.append(f)
    if a.bits_sent != b.bits_sent:
        bad.append("bits_sent")
    return bad


def _p23_split_single_leaf():
    """Planted: a ``LeafSpecCompressor`` that draws a single leaf's plan by
    its path, as a leaf of a larger tree would: the flat round's plan is
    lost."""
    from repro_torch.core import tree
    from repro_torch.methods import LeafSpecCompressor
    from repro_torch.methods.substrates import _leaf_size

    class Split(LeafSpecCompressor):
        def leaf_plans(self, rnd, per_node_tree, lanes=False):
            return {path: rnd.leaf_plan(path, self._leaf_rc(
                int(_leaf_size(leaf, lanes))))
                for path, leaf in tree.items(per_node_tree)}
    return Split


def _p23_shared_generator():
    """Planted: a ``LeafSpecCompressor`` that draws every leaf's plan from
    one shared generator (the round's flat seed), not one seeded by the
    leaf's path."""
    from repro_torch.core import tree
    from repro_torch.core.rng import derive_seed
    from repro_torch.methods import LeafSpecCompressor
    from repro_torch.methods.substrates import _leaf_size

    class Shared(LeafSpecCompressor):
        def leaf_plans(self, rnd, per_node_tree, lanes=False):
            seed = derive_seed(rnd.seed, rnd.t, "compress")
            return {path: self._leaf_rc(int(_leaf_size(leaf, lanes))).plan(
                seed) for path, leaf in tree.items(per_node_tree)}
    return Shared


def _p23_bridge(torch, smi: str, problem, L: float):
    """23a: single-leaf tree == flat, bit for bit, at real-sim's shape."""
    from repro_torch.compress import make_round_compressor
    from repro_torch.methods import (FlatSubstrate, Hyper, LeafProblemOracle,
                                     Method, TreeSubstrate)
    from repro_torch.optim.base import SGD
    n, d = N_NODES, D_REALSIM
    x0 = torch.zeros(d, device="cuda")
    oracle = LeafProblemOracle.wrapping(problem, {"w": x0})
    cases = [("dasha", "randk", dict(k=K_RANDK), "dasha_sparsify_update"),
             ("page", "randk", dict(k=K_RANDK), "dasha_sparsify_update"),
             ("marina", "randk", dict(k=K_RANDK), "dasha_sparsify_update"),
             ("dasha", "qdither", dict(s=S_QDITHER), "quantize")]
    rows = []
    for variant, name, ckw, kernel in cases:
        rc = make_round_compressor(name, d, n, backend="fused",
                                   device="cuda", **ckw)
        theory = dict(B=1, m=M_REALSIM) if variant == "page" else \
            dict(zeta=K_RANDK, d=d) if variant == "marina" else {}
        hp = Hyper.from_theory(variant, rc.omega, n, L=L, gamma_mult=16,
                               **theory)
        if variant in ("page", "marina"):      # coins inside the run
            hp = dataclasses.replace(hp, p=0.1)
        flat = Method.build(variant, rc, FlatSubstrate(problem, n, d), hp)
        treem = Method.build(variant, rc, TreeSubstrate(
            oracle, n, SGD(lr=hp.gamma)), hp)
        sf = flat.init(x0, 1, device="cuda")
        st = treem.init({"w": x0}, 1, device="cuda")
        _reset_launch_counts()
        t0 = time.perf_counter()
        coins = 0
        for _ in range(P23_ROUNDS):
            sf, fi = flat.step_full(sf)
            st, ti = treem.step_full(st)
            coins += bool(fi.coin)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        tag = f"p23-bridge {variant}/{name}"
        _gate_launches(tag, counts, {kernel: 2 * P23_ROUNDS})
        bad = _p23_fields_equal(torch, st, sf, "w")
        if bad:
            raise AssertionError(f"[{tag}] single-leaf tree and flat differ "
                                 f"in {bad} after {P23_ROUNDS} rounds")
        gsq = float(torch.sum(problem.grad_f(sf.x) ** 2))
        if not math.isfinite(gsq):
            raise AssertionError(f"[{tag}] ||grad f||^2 = {gsq}")
        rows.append({"variant": variant, "compressor": name,
                     "rounds": P23_ROUNDS, "sync_coins": coins,
                     "wall_s": wall, "launches": counts[kernel],
                     "grad_sq_end": gsq, "bit_equal": True})
        if (variant, name) == ("dasha", "randk"):
            planted = Method.build(variant, _p23_split_single_leaf()(
                rc), TreeSubstrate(oracle, n, SGD(lr=hp.gamma)), hp)
            sp = planted.init({"w": x0}, 1, device="cuda")
            sf = flat.init(x0, 1, device="cuda")
            for _ in range(3):
                sp, sf = planted.step(sp), flat.step(sf)
            bad = _p23_fields_equal(torch, sp, sf, "w")
            if not bad:
                raise AssertionError(f"[{tag}] the planted split-leaf "
                                     "compressor equals the flat run")
            rows[-1]["planted_split_leaf_differs_in"] = bad
    log(f"[p23-bridge] single-leaf tree == flat bit for bit at ({n}, {d}), "
        f"{P23_ROUNDS} rounds each: {rows} | {smi}")
    return rows


def _p23_trainer_method(torch, cfg, name: str, dev: str, n: int, d: int,
                        cls=None):
    """DASHA-MVR on ``cfg``'s LM through ``Method.build`` with the registry
    compressor ``name`` (fused) on the tree substrate, SGD server.  ``d``:
    the largest leaf's coordinates a node.  The spec is re-dimensioned leaf
    by leaf, but ``Hyper.a`` is one number: it is momentum_a(omega) of the
    largest leaf, the smallest a of any leaf (QDither's omega grows with
    d; Bernoulli's does not depend on it)."""
    from repro_torch.compress import make_round_compressor
    from repro_torch.compress.spec import momentum_a
    from repro_torch.methods import (BatchLossOracle, Hyper,
                                     LeafSpecCompressor, Method,
                                     TreeSubstrate)
    from repro_torch.models import lm
    from repro_torch.optim.base import SGD
    kw = dict(p=0.25) if name == "bernoulli" else dict(s=S_QDITHER)
    rc = make_round_compressor(name, d, n, backend="fused", device=dev,
                               **kw)
    comp = (cls or LeafSpecCompressor)(rc)
    sub = TreeSubstrate(BatchLossOracle(
        lambda p, b: lm.loss_fn(cfg, p, b)[0]), n, SGD(lr=0.05))
    hp = Hyper(gamma=0.05, a=momentum_a(rc.omega), b=0.1, variant="mvr")
    return Method.build("mvr", rc if cls is None else comp, sub, hp), comp, \
        hp.a


def _p23_registry_trainer(torch, smi: str):
    """23b: whisper-tiny's trainer at full width with registry compressors
    on the tree substrate; card vs CPU and the per-leaf plan gate at its
    smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches, modality_kw)
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    from repro_torch.models import init_params
    n = TRAIN_NODES
    cfg = get_config(CROSS_AUDIO)
    params = _gate_cross_blocks(init_params(cfg, 0, device="cuda"))
    n_params = sum(p.numel() for p in tree.leaves(params))
    leaves = len(tree.leaves(params))
    d_max = max(p.numel() for p in tree.leaves(params))
    if leaves != CROSS_LEAVES[CROSS_AUDIO]:
        raise AssertionError(f"[p23-train] {leaves} leaves, expected "
                             f"{CROSS_LEAVES[CROSS_AUDIO]}")
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size,
                               seq_len=WHISPER_TRAIN_SEQ)
    rounds = P23_TRAIN_WARMUP + P23_TRAIN_ROUNDS
    batches = [make_node_batches(t, text, n, TRAIN_BATCH, device="cuda",
                                 **modality_kw(cfg)) for t in range(rounds)]
    full = {}
    for name, kernel in (("bernoulli", "dasha_sparsify_update"),
                         ("qdither", "quantize")):
        method, _, a = _p23_trainer_method(torch, cfg, name, "cuda", n,
                                           d_max)
        state = method.init(params, 1, init_mode="zeros", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        for t in range(P23_TRAIN_WARMUP):
            state = method.step(state, batches[t])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(P23_TRAIN_WARMUP, rounds):
            state = method.step(state, batches[t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        _gate_launches(f"p23-train {name}", counts, {kernel: leaves * rounds})
        bad = [p for p, g in tree.items(state.g)
               if not bool(torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"[p23-train] {name}: non-finite g at "
                                 f"{bad[:3]}")
        tokens = n * TRAIN_BATCH * WHISPER_TRAIN_SEQ
        full[name] = {"rounds_timed": P23_TRAIN_ROUNDS, "a": a,
                      "rounds_per_s": P23_TRAIN_ROUNDS / wall,
                      "tokens_per_s": P23_TRAIN_ROUNDS * tokens / wall,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts,
                      "bits_sent": float(state.bits_sent)}
        del method, state
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[p23-train] whisper-tiny at full width ({n_params / 1e6:.2f}M "
        f"params, {leaves} leaves), n = {n} x {TRAIN_BATCH} x "
        f"{WHISPER_TRAIN_SEQ} tokens, DASHA-MVR through Method.build with "
        f"registry compressors on the tree substrate: {full} | {smi}")
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()

    # the smoke config: card vs CPU on CPU-drawn per-leaf plans, then the
    # round's own plans against the documented path-seeded draws
    cfg, params, _ = _cross_smoke(torch, CROSS_AUDIO)
    d_max = max(p.numel() for p in tree.leaves(params))
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batches = [make_node_batches(t, text, n, 2, device="cpu",
                                 **modality_kw(cfg))
               for t in range(P23_AGREE_ROUNDS)]
    zeros = tree.map_leaves(lambda p: torch.zeros((n,) + tuple(p.shape)),
                            params)

    def to(dev, obj):
        if isinstance(obj, torch.Tensor):
            return obj.to(dev)
        if isinstance(obj, dict):
            return {k: to(dev, v) for k, v in obj.items()}
        if hasattr(obj, "_fields"):
            return obj._replace(**{f: to(dev, getattr(obj, f))
                                   for f in obj._fields
                                   if isinstance(getattr(obj, f),
                                                 torch.Tensor)})
        return obj

    def run(name, dev, plans, prm=params, cls=None, rounds=None):
        method, comp, _ = _p23_trainer_method(torch, cfg, name, dev, n,
                                              d_max, cls)
        st = method.init(to(dev, prm), 1, init_mode="zeros", device=dev)
        trace = []
        for t in range(rounds or P23_AGREE_ROUNDS):
            dr = None if plans is None else Draws(leaf_plans=to(dev,
                                                                plans[t]))
            st = method.step_full(st, to(dev, batches[t]), draws=dr)[0]
            trace.append(float(sum(torch.sum(g.double() ** 2)
                                   for g in tree.leaves(st.g))))
        return st, comp, trace

    def trace_gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def leaf_launches(plans):
        """The card's QDither run, each fused launch (one a leaf a round)
        held against its plain version on the same inputs by phase 2's
        one-level rule: (the run, flips, worst agreeing error, launches)."""
        calls = []
        real = kern.dasha_quantize_update

        def recorded(h_new, h, g_local, u, a, scale, levels):
            out = real(h_new, h, g_local, u, a, scale, levels)
            delta = h_new - h - a * (g_local - h)
            plain = ref.dasha_quantize_update_ref(h_new, h, g_local, u, a,
                                                  scale, levels)[0]
            agree = kern.quantize_agreement(out[0], plain, delta,
                                            u.expand_as(delta), levels,
                                            scale)
            calls.append((agree, torch.equal(out[2], g_local + out[0])))
            return out
        with _patched(kern, "dasha_quantize_update", recorded):
            res = run("qdither", "cuda", plans)
        bad = [j for j, (ag, g_ok) in enumerate(calls)
               if not (ag["ok"] and g_ok)]
        if bad:
            raise AssertionError(f"[p23-agree] qdither: the trainer's "
                                 f"launches {bad[:5]} of {len(calls)} break "
                                 f"the one-level rule against the plain "
                                 f"version")
        return (res, sum(ag["flips"] for ag, _ in calls),
                max(ag["max_abs_err"] for ag, _ in calls), len(calls))

    # Bernoulli: every state leaf; QDither: each launch leaf by leaf against
    # its plain version (above), and the ||g||^2 trace (phase 4's form)
    # card vs CPU, since kernel 2 sums a row's norm in another order than
    # torch.sum and moves an element one level (norm / s) where its uniform
    # lies within ~1e-6 of the level's boundary: on a leaf of a few
    # hundred coordinates one such element is a large share of the leaf
    # (0.50 of its largest magnitude on the H100)
    agree = {}
    for name in ("bernoulli", "qdither"):
        _, comp, _ = _p23_trainer_method(torch, cfg, name, "cpu", n, d_max)
        plans = [comp.leaf_plans(RoundRandom(9, t), zeros)
                 for t in range(P23_AGREE_ROUNDS)]
        cpu, _, tcpu = run(name, "cpu", plans)
        leafwise = None
        if name == "qdither":
            (card, _, tcard), flips, leaf_err, calls = leaf_launches(plans)
            leafwise = {"launches": calls, "flips": flips,
                        "max_abs_err": leaf_err}
        else:
            card, _, tcard = run(name, "cuda", plans)
        if name == "bernoulli":
            def gap(st, tr):
                return _states_agree(torch, st, cpu, math.inf)
        else:
            def gap(st, tr):
                return trace_gap(tr, tcpu)
        err = gap(card, tcard)
        control, limit = None, DENSE_AGREE_LIMIT
        if err > limit:
            gen = torch.Generator().manual_seed(1)
            nudged, _, tn = run(name, "cpu", plans, tree.map_leaves(
                lambda w: w * (1 + HALF_ULP_F32 * torch.randn(
                    w.shape, generator=gen)), params))
            control = gap(nudged, tn)
            limit = max(limit, HYBRID_CONTROL_FACTOR * control)
        form = "state leaves" if name == "bernoulli" else "||g||^2 trace"
        if not err <= limit:
            raise AssertionError(f"[p23-agree] {name}: card and CPU differ "
                                 f"by {err} (limit {limit}; {form})")
        agree[name] = {"gate": form, "worst": err,
                       "control": control, "limit": limit,
                       "leaf_launches_one_level_rule": leafwise,
                       "state_leaves_worst": _states_agree(
                           torch, card, cpu, math.inf)}
    # the round's own plans are the documented per-path draws (one round)
    own, comp, _ = run("bernoulli", "cuda", None, rounds=1)
    documented = [comp.leaf_plans(RoundRandom(1, 0), to("cuda", zeros))]
    injected, _, _ = run("bernoulli", "cuda", documented, rounds=1)
    bad = _p23_fields_equal_tree(torch, own, injected)
    if bad:
        raise AssertionError(f"[p23-plans] the round's own per-leaf plans "
                             f"are not the path-seeded ones: {bad[:3]}")
    shared, _, _ = run("bernoulli", "cuda", None, rounds=1,
                       cls=_p23_shared_generator())
    if not _p23_fields_equal_tree(torch, shared, injected):
        raise AssertionError("[p23-plans] the planted shared-generator "
                             "compressor passes the per-leaf plan gate")
    log(f"[p23-agree] whisper smoke, registry compressors on the tree "
        f"substrate, card vs CPU on CPU-drawn per-leaf plans: {agree}; the "
        f"round's own plans are the path-seeded ones, the shared-generator "
        f"plant fails")
    return {"full_width": full, "params": n_params, "leaves": leaves,
            "agreement": agree, "planted": {"shared generator": "caught"}}


def _p23_fields_equal_tree(torch, a, b):
    """(field, path) of every leaf where two tree states differ in a bit."""
    from repro_torch.core import tree
    bad = []
    for f in ("x", "g", "g_local", "h_local"):
        for path, w in tree.items(getattr(b, f)):
            if not torch.equal(tree.get(getattr(a, f), path), w):
                bad.append((f, path))
    return bad


def _p23_seed_api(torch, smi: str, problem, L: float):
    """23c: the seed-era entry points equal Method.build runs bit for bit;
    empirical omega within the spec's bound."""
    import warnings
    from repro_torch.compress.legacy import (NodeCompressor, PermK, QDither,
                                             RandK, empirical_omega,
                                             make_compressor)
    from repro_torch.core import dasha as cdasha
    from repro_torch.core import marina as cmarina
    from repro_torch.core.oracles import StochasticProblem
    from repro_torch.methods import FlatSubstrate, Hyper, Method
    n, d = N_NODES, D_REALSIM
    x0 = torch.zeros(d, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        nc = NodeCompressor(make_compressor("randk", d, k=K_RANDK), n,
                            backend="fused", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    diag = 1.0 + torch.rand(d, generator=gen, device="cuda")
    bvec = torch.randn(d, generator=gen, device="cuda")

    def qloss(x, xi, i):
        return 0.5 * torch.sum(diag * x * x) - bvec @ x + xi @ x

    def sample(g, i, batch):
        return 0.3 * torch.randn((batch, d), generator=g, device=g.device)

    stoch = StochasticProblem(qloss, sample, n, device="cuda",
                              true_grad=lambda x: diag * x - bvec)
    rows = {}

    def same(tag, got, want):
        (fa, ma, ba), (fb, mb, bb) = got, want
        bad = [f for f in ("x", "g", "g_local", "h_local")
               if not torch.equal(getattr(fa, f), getattr(fb, f))]
        if not (ma == mb).all() or not (ba == bb).all():
            bad.append("traces")
        if bad:
            raise AssertionError(f"[p23-seed] {tag}: the seed-era run and "
                                 f"the Method.build run differ in {bad}")
        rows[tag] = {"rounds": P23_SEED_ROUNDS, "metric_end": float(ma[-1]),
                     "bit_equal": True}

    _reset_launch_counts()
    hp = Hyper.from_theory("dasha", nc.omega, n, L=L, gamma_mult=16)
    st = cdasha.init(x0, n, 1, problem=problem, hyper=hp, device="cuda")
    same("dasha", cdasha.run(st, hp, problem, nc, P23_SEED_ROUNDS),
         Method.build("dasha", nc.rc, FlatSubstrate(problem, n, d), hp).run(
             st, P23_SEED_ROUNDS))
    for variant in ("marina", "vr", "vr_online"):
        prob = stoch if variant == "vr_online" else problem
        mhp = cmarina.MarinaHyper(gamma=0.5 / L if prob is problem
                                  else 0.02, p=0.1, variant=variant,
                                  batch=4, batch_sync=16)
        st = cmarina.init(x0, 1, prob, device="cuda")
        same(variant, cmarina.run(st, mhp, prob, nc, P23_SEED_ROUNDS),
             Method.build("marina", nc.rc, FlatSubstrate(prob, n, d),
                          cmarina._hyper(mhp)).run(st, P23_SEED_ROUNDS))
    counts = _launch_counts()
    _gate_launches("p23-seed", counts, {
        "dasha_sparsify_update": 2 * 4 * P23_SEED_ROUNDS})
    x = torch.randn(d, generator=gen, device="cuda")
    omega = {}
    for comp, g in ((RandK(d, K_RANDK), gen),
                    (PermK(d, n), torch.Generator().manual_seed(1)),
                    (QDither(d, S_QDITHER), gen)):
        name = type(comp).__name__.lower()
        emp = empirical_omega(comp, g, x, trials=P23_OMEGA_TRIALS)
        bound_ = comp.omega * P23_OMEGA_TOL[name] + 0.05
        if not emp <= bound_:
            raise AssertionError(f"[p23-seed] {name}: empirical omega {emp} "
                                 f"over the bound {bound_}")
        omega[name] = {"empirical": emp, "spec": comp.omega,
                       "bound": bound_}
    log(f"[p23-seed] core.dasha.run / core.marina.run == Method.build runs "
        f"bit for bit at ({n}, {d}): {rows}; empirical omega {omega} | "
        f"{smi}")
    return {"runs": rows, "omega": omega,
            "launches": counts["dasha_sparsify_update"]}


def _p23_coin_spy():
    """A context that records every coin the rounds draw, in order."""
    from repro_torch.core.rng import RoundRandom
    real, seen = RoundRandom.coin, []

    def spy(self, p, tag):
        out = real(self, p, tag)
        seen.append(out)
        return out

    @contextlib.contextmanager
    def watching():
        RoundRandom.coin = spy
        try:
            yield seen
        finally:
            RoundRandom.coin = real
    return watching()


def _p23_lanes_vs_runs(torch, tag, build, values, state, rounds, *,
                       data=None, exact=False, watch_coins=False,
                       limit=0.0):
    """Step a method of G lanes and G one-lane methods side by side from
    ``state``: the coins every round (``watch_coins``), the participation
    and bits exactly, then each field within ``limit`` of its largest
    magnitude, or bit for bit with ``exact``.  Returns
    (worst error, lane launches, rounds whose coins differ by lane, the
    lanes' final state)."""
    import numpy as np
    from repro_torch.core import tree
    from repro_torch.methods.driver import _broadcast_lanes
    lanes = build(np.asarray(values))
    G = len(values)
    ls = _broadcast_lanes(state, G, torch.device("cuda"))
    lane_coins = []
    _reset_launch_counts()
    with _p23_coin_spy() as seen:
        for t in range(rounds):
            seen.clear()
            ls, li = lanes.step_full(ls, data)
            lane_coins.append((list(seen), li.present))
    lane_launches = _launch_counts()
    mixed, worst = 0, 0.0
    finals = []
    with _p23_coin_spy() as seen:
        for j, v in enumerate(values):
            one = build(float(v))
            st = state
            for t in range(rounds):
                seen.clear()
                st, info = one.step_full(st, data)
                coins, present = lane_coins[t]
                if watch_coins:
                    if len(seen) != len(coins) or any(
                            bool(np.broadcast_to(c, (G,))[j]) != bool(o)
                            for c, o in zip(coins, seen)):
                        raise AssertionError(f"[{tag}] lane {j}'s coins "
                                             f"{coins} at round {t}, its run "
                                             f"drew {seen}")
                if present is not None and not torch.equal(present,
                                                           info.present):
                    raise AssertionError(f"[{tag}] lane {j}: another cohort "
                                         f"at round {t}")
            finals.append(st)
    if watch_coins:
        mixed = sum(len({bool(x) for x in np.broadcast_to(c, (G,))}) > 1
                    for coins, _ in lane_coins for c in coins)
    for j, st in enumerate(finals):
        if not np.float32(ls.bits_sent[j]) == np.float32(st.bits_sent):
            raise AssertionError(f"[{tag}] lane {j}: bits_sent "
                                 f"{ls.bits_sent[j]} != {st.bits_sent}")
        if exact:
            off = []
            for f in ("x", "g", "g_local", "h_local"):
                for path, w in tree.items(getattr(st, f)):
                    g = tree.get(getattr(ls, f), path)[j]
                    if not torch.equal(g, w):
                        off.append((f, path, float(
                            (g.float() - w.float()).abs().max()
                            / max(float(w.float().abs().max()), 1e-30))))
            if off:
                raise AssertionError(f"[{tag}] lane {j} differs from its "
                                     f"run in {len(off)} leaves, worst "
                                     f"{max(o[2] for o in off)} of a leaf's "
                                     f"largest magnitude: {off[:3]}")
        else:
            lane = ls._replace(**{f: getattr(ls, f)[j]
                                  for f in SWEEP_STATE})
            errs = {}
            for f in SWEEP_STATE:
                a, b = getattr(lane, f), getattr(st, f)
                errs[f] = float((a - b).abs().max()) / max(
                    float(b.abs().max()), 1e-30)
            worst = max(worst, max(errs.values()))
            if not max(errs.values()) <= limit:
                raise AssertionError(f"[{tag}] lane {j} off its run: {errs} "
                                     f"of each field's largest magnitude "
                                     f"(limit {limit})")
    return worst, lane_launches, mixed, ls


def _p23_sweeps(torch, smi: str, problem, L: float):
    """23d: the sweep's new lanes against sequential runs."""
    from repro_torch.compress import make_round_compressor
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches,
                                           synthetic_classification)
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.methods import (BatchLossOracle, FlatSubstrate, Hyper,
                                     Method, SampledFlatSubstrate,
                                     TreeCompression, TreeSubstrate)
    from repro_torch.models import init_params, lm
    from repro_torch.optim.base import SGD
    n, d = N_NODES, D_REALSIM
    R = P23_SWEEP_ROUNDS
    x0 = torch.zeros(d, device="cuda")
    rc = make_round_compressor("randk", d, n, k=K_RANDK, backend="fused",
                               device="cuda")
    base = Hyper.from_theory("dasha", rc.omega, n, L=L, gamma_mult=16)
    out = {}

    def page(p):
        return Method.build("page", rc, FlatSubstrate(problem, n, d),
                            dataclasses.replace(base, variant="page", p=p,
                                                batch=1))
    st = page(0.1).init(x0, 1, device="cuda")
    worst, launches, mixed, _ = _p23_lanes_vs_runs(
        torch, "p23-sweep p", page, P23_P_LANES, st, R, watch_coins=True,
        limit=P23_LANE_LIMIT["p"])
    _gate_launches("p23-sweep p", launches, {"dasha_sparsify_update": R})
    if not mixed:
        raise AssertionError("[p23-sweep p] no round drew coins that differ "
                             "by lane")
    out["p"] = {"lanes": len(P23_P_LANES), "rounds": R, "worst": worst,
                "limit": P23_LANE_LIMIT["p"], "mixed_coin_rounds": mixed}

    def dasha_a(a):
        return Method.build("dasha", rc, FlatSubstrate(problem, n, d),
                            dataclasses.replace(base, a=a))
    a_lanes = [base.a * 2.0 ** k for k in P23_A_POWERS]
    st = dasha_a(base.a).init(x0, 1, device="cuda")
    worst, launches, _, ls = _p23_lanes_vs_runs(
        torch, "p23-sweep a", dasha_a, a_lanes, st, R,
        limit=P23_LANE_LIMIT["a"])
    _gate_launches("p23-sweep a", launches, {"dasha_sparsify_update": R})

    # a enters a round through a (g_i - h_i), which the rounds keep small,
    # and the lanes' gradients differ from their runs' by the oracle's
    # rounding, which d/K amplifies (one round from the sweep's state: g_i
    # 8.2e-4 of its largest magnitude off, the same on the dense backend,
    # on the H100).  So the round's estimator update is held on
    # its own: from the sweep's final state and the lane oracle's one
    # gradient, the lanes' update (one kernel-1 launch, a read per row)
    # against each lane's one-lane update (a scalar a), bit for bit
    from repro_torch.core.rng import RoundRandom
    from repro_torch.methods import Lanes
    flat = FlatSubstrate(problem, n, d).with_compressor(rc)
    lane_sub = flat.with_lanes(len(a_lanes))
    h_new = lane_sub.grad(RoundRandom(ls.seed, ls.t), ls.x)

    def one_update():
        """The lanes whose update differs in any bit from their one-lane
        update on the same inputs."""
        lane = lane_sub.estimator_update_full(
            RoundRandom(ls.seed, ls.t), h_new, ls.h_local, ls.g_local,
            Lanes(a_lanes))
        bad = []
        for j, v in enumerate(a_lanes):
            one = flat.estimator_update_full(
                RoundRandom(ls.seed, ls.t), h_new[j], ls.h_local[j],
                ls.g_local[j], v)
            if not (torch.equal(lane[0][j], one[0])
                    and torch.equal(lane[2][j], one[2])):
                bad.append(j)
        return bad
    bad = one_update()
    if bad:
        raise AssertionError(f"[p23-sweep a] the lanes' estimator update "
                             f"differs from the one-lane updates at lanes "
                             f"{bad}")
    # planted: the kernel reads row r's a at r % G in place of r / n
    real = kern.lane_values

    def row_mod_g(name, what, v, rows, device):
        ka, t, div = real(name, what, v, rows, device)
        if t is None:
            return ka, t, div
        return ka, t.repeat(rows // t.numel()).contiguous(), 1
    kern.lane_values = row_mod_g
    try:
        planted = one_update()
    finally:
        kern.lane_values = real
    if not planted:
        raise AssertionError("[p23-sweep a] a per-row a read at row % G "
                             "passes the update gate")
    out["a"] = {"lanes": len(a_lanes), "values": a_lanes, "rounds": R,
                "worst": worst, "limit": P23_LANE_LIMIT["a"],
                "update_bit_equal": True,
                "planted_row_mod_g_lanes_off": planted,
                "rows_a_launch": n * len(a_lanes)}

    # b on the fused MVR tree path (kernel 3) at starcoder2's smoke config
    cfg = get_smoke_config("starcoder2-3b")
    params = init_params(cfg, 0, device="cuda")
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batch = make_node_batches(0, text, TRAIN_NODES, 2, device="cuda")
    sub = TreeSubstrate(BatchLossOracle(lambda p, b: lm.loss_fn(
        cfg, p, b)[0]), TRAIN_NODES, SGD(lr=0.05))
    comp = TreeCompression(n=TRAIN_NODES, p=0.25, use_kernel=True)

    def mvr_b(b):
        return Method.build("mvr", comp, sub, Hyper(gamma=0.05, a=0.2, b=b,
                                                    variant="mvr"))
    st = mvr_b(0.1).init(params, 1, init_mode="zeros", device="cuda")
    leaves = len(tree.leaves(params))
    _, launches, _, _ = _p23_lanes_vs_runs(
        torch, "p23-sweep b", mvr_b, P23_B_LANES, st, 3, data=batch,
        exact=True)
    _gate_launches("p23-sweep b", launches, {"dasha_mvr_update": 3 * leaves})
    out["b"] = {"lanes": len(P23_B_LANES), "rounds": 3, "leaves": leaves,
                "bit_equal": True}
    del params, batch, st
    gc.collect()

    # lanes on the sampled substrate
    ns, c, G = P23_SAMPLED
    feats, labels = synthetic_classification(1, ns, 1, d, device="cuda")
    sprob = FiniteSumProblem(_glm_loss(torch), feats, labels)
    src = make_round_compressor("randk", d, ns, k=K_RANDK, backend="fused",
                                device="cuda")
    sub_s = SampledFlatSubstrate(sprob, ns, d, c=c)
    shp = Hyper.from_theory("dasha", sub_s.with_compressor(
        src).effective_omega(), ns, L=L, gamma_mult=16)

    def sampled(gamma):
        return Method.build("dasha", src, sub_s,
                            dataclasses.replace(shp, gamma=gamma))
    gammas = [shp.gamma * 2.0 ** k for k in range(-2, G - 2)]
    st = sampled(shp.gamma).init(x0, 1, device="cuda")
    _, launches, _, _ = _p23_lanes_vs_runs(
        torch, "p23-sweep sampled", sampled, gammas, st, R, exact=True)
    _gate_launches("p23-sweep sampled", launches,
                   {"dasha_sparsify_update": R})
    out["sampled"] = {"n": ns, "c": c, "lanes": G, "rounds": R,
                      "bit_equal": True, "rows_a_launch": G * c}
    del feats, labels, sprob, st
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[p23-sweep] lanes against sequential runs (the flat lanes' worst "
        f"field error of its largest magnitude, within {P23_LANE_LIMIT}; "
        f"the tree and sampled lanes bit for bit): {out} | {smi}")
    return out, {"dasha_sparsify_update": 3 * R,
                 "dasha_mvr_update": 3 * leaves}


def _p23_kernel_rows(torch, smi: str):
    """23e: kernels 1-3 with per-row a / b against their plain versions
    and against one scalar launch a lane, timed beside their bounds."""
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    from repro_torch.methods import Lanes
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def lanes_of(t, G):
        return t.view(G, -1, t.shape[-1])

    # kernel 1: 8 lanes x 5 nodes of real-sim rows, the plan's RandK indices
    G, n, d, k = len(P23_A_LANES), N_NODES, D_REALSIM, K_RANDK
    # the lane values as the methods layer hands them over: (G,) fp32,
    # 1 - b formed in double before its one rounding
    a = Lanes(P23_A_LANES).as_vector("cuda")
    grad, h, gl = rnd(G * n, d), rnd(G * n, d), rnd(G * n, d)
    idx = torch.topk(torch.rand((n, d), generator=gen, device="cuda"), k,
                     dim=1).indices.contiguous()
    scale = d / k
    out = kern.dasha_sparsify_update(grad, h, gl, a, scale, indices=idx)
    plain = ref.dasha_sparsify_update_ref(grad, h, gl, a, scale,
                                          indices=idx)
    per_lane = [kern.dasha_sparsify_update(
        lanes_of(grad, G)[j], lanes_of(h, G)[j], lanes_of(gl, G)[j],
        P23_A_LANES[j], scale, indices=idx) for j in range(G)]
    ok = torch.equal(out[0], plain[0]) and torch.equal(out[2], plain[2])
    ok = ok and all(torch.equal(lanes_of(out[0], G)[j], m[0]) and
                    torch.equal(lanes_of(out[2], G)[j], m[2])
                    for j, m in enumerate(per_lane))
    if not ok:
        raise AssertionError("[p23-kernels] kernel 1 with per-row a is not "
                             "bit-equal to its plain version and to one "
                             "scalar launch a lane")
    nbytes = 20 * G * n * d + idx.numel() * 8 + G * 4
    t_b, by = bound(nbytes, 6 * G * n * d)
    rows["dasha_sparsify_update"] = {
        "shape": [G * n, d], "form": "per-row a, RandK indices",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: kern.dasha_sparsify_update(
            grad, h, gl, a, scale, indices=idx)),
        "scalar_ms": time_ms(torch, lambda: kern.dasha_sparsify_update(
            grad, h, gl, 0.1, scale, indices=idx)),
        "plain_ms": time_ms(torch, lambda: ref.dasha_sparsify_update_ref(
            grad, h, gl, a, scale, indices=idx)),
        "bound_ms": t_b, "bound_by": by, "library_ms": None}

    # kernel 3: 4 lanes x 4 nodes of real-sim rows, one bool draw a node
    G3, n3 = len(P23_B_LANES), TRAIN_NODES
    a3_lanes = (0.1, 0.2, 0.3, 0.4)
    a3 = Lanes(a3_lanes).as_vector("cuda")
    c3 = (1.0 - Lanes(P23_B_LANES)).as_vector("cuda")
    gn, go, h3, gl3 = (rnd(G3 * n3, d) for _ in range(4))
    mask = torch.rand((n3, d), generator=gen, device="cuda") < 0.25
    out = kern.dasha_mvr_update(gn, go, h3, gl3, mask, a3, None, 4.0, c=c3)
    plain = ref.dasha_mvr_update_ref(gn, go, h3, gl3, mask, a3, None, 4.0,
                                     c=c3)
    ok = all(torch.equal(x, y) for x, y in zip(out, plain))
    for j in range(G3):
        sl = slice(j * n3, (j + 1) * n3)
        one = kern.dasha_mvr_update(gn[sl], go[sl], h3[sl], gl3[sl], mask,
                                    a3_lanes[j], P23_B_LANES[j], 4.0)
        ok = ok and all(torch.equal(x[sl], y) for x, y in zip(out, one))
    if not ok:
        raise AssertionError("[p23-kernels] kernel 3 with per-row a and b "
                             "is not bit-equal to its plain version and to "
                             "one scalar launch a lane")
    # the (n3, d) bool draw is shared by the lanes (row r % n3): once
    t_b, by = bound(28 * G3 * n3 * d + n3 * d + 2 * G3 * 4,
                    9 * G3 * n3 * d)
    rows["dasha_mvr_update"] = {
        "shape": [G3 * n3, d], "form": "per-row a and 1 - b, bool draw",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: kern.dasha_mvr_update(
            gn, go, h3, gl3, mask, a3, None, 4.0, c=c3)),
        "scalar_ms": time_ms(torch, lambda: kern.dasha_mvr_update(
            gn, go, h3, gl3, mask, 0.2, 0.3, 4.0)),
        "plain_ms": time_ms(torch, lambda: ref.dasha_mvr_update_ref(
            gn, go, h3, gl3, mask, a3, None, 4.0, c=c3)),
        "bound_ms": t_b, "bound_by": by, "library_ms": None}

    # kernel 2's fused QDither entry: 8 lanes x 5 nodes on (5, d) uniforms
    hn, hq, gq = rnd(G, n, d), rnd(G, n, d), rnd(G, n, d)
    u = torch.rand((n, d), generator=gen, device="cuda")
    m, _, g_new = kern.dasha_quantize_update(hn, hq, gq, u, a, 1.0,
                                             S_QDITHER)
    for j in range(G):
        mj, _, gj = kern.dasha_quantize_update(
            hn[j].contiguous(), hq[j].contiguous(), gq[j].contiguous(), u,
            P23_A_LANES[j], 1.0, S_QDITHER)
        if not (torch.equal(m[j], mj) and torch.equal(g_new[j], gj)):
            raise AssertionError(f"[p23-kernels] kernel 2 with per-row a, "
                                 f"lane {j}, is not bit-equal to its scalar "
                                 "launch")
    delta = hn - hq - ref.per_row(a, hn) * (gq - hq)
    pm = ref.dasha_quantize_update_ref(hn, hq, gq, u, a, 1.0, S_QDITHER)[0]
    agree = kern.quantize_agreement(m.view(G * n, d), pm.view(G * n, d),
                                    delta.view(G * n, d),
                                    u.repeat(G, 1), S_QDITHER)
    if not agree["ok"] or not torch.equal(g_new, gq + m):
        raise AssertionError(f"[p23-kernels] kernel 2 with per-row a against "
                             f"its plain version: {agree}")
    # the (n, d) uniforms are shared by the lanes (row r % n): once
    t_b, by = bound(20 * G * n * d + 4 * n * d + G * 4, 20 * G * n * d)
    rows["dasha_quantize_update"] = {
        "shape": [G, n, d], "form": "per-row a, (n, d) uniforms",
        "max_abs_err": agree["max_abs_err"], "flips": agree["flips"],
        "ms": time_ms(torch, lambda: kern.dasha_quantize_update(
            hn, hq, gq, u, a, 1.0, S_QDITHER)),
        "scalar_ms": time_ms(torch, lambda: kern.dasha_quantize_update(
            hn, hq, gq, u, 0.1, 1.0, S_QDITHER)),
        "plain_ms": time_ms(torch, lambda: ref.dasha_quantize_update_ref(
            hn, hq, gq, u, a, 1.0, S_QDITHER)),
        "bound_ms": t_b, "bound_by": by, "library_ms": None}
    log(f"[p23-kernels] per-row a / b forms, bit-equal to the plain versions "
        f"(kernel 2 by the one-level rule) and to one scalar launch a lane: "
        f"{rows} | {smi}")
    return rows


def phase_registry(torch, smi: str):
    """Phase 23: registry compressors on the tree substrate (23a, 23b), the
    seed-era API (23c), the sweep's new lanes (23d) and the kernels'
    per-row a / b forms (23e).  Returns the report, the launches of the
    main paths it drove (by kernel), and the kernel rows."""
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        res = fn(torch, *args)
        walls[name] = time.perf_counter() - t1
        log(f"[p23] {name} in {walls[name]:.1f} s")
        return res

    n, m, d = N_NODES, M_REALSIM, D_REALSIM
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    bridge = part("bridge", _p23_bridge, smi, problem, L)
    seed = part("seed_api", _p23_seed_api, smi, problem, L)
    sweeps, sweep_launches = part("sweeps", _p23_sweeps, smi, problem, L)
    del feats, labels, problem
    gc.collect()
    torch.cuda.empty_cache()
    trainer = part("registry_trainer", _p23_registry_trainer, smi)
    rows = part("kernel_rows", _p23_kernel_rows, smi)
    leaves = trainer["leaves"]
    rounds = P23_TRAIN_WARMUP + P23_TRAIN_ROUNDS
    launches = {
        "dasha_sparsify_update": sum(r["launches"] for r in bridge
                                     if r["compressor"] == "randk")
        + seed["launches"] + sweep_launches["dasha_sparsify_update"]
        + leaves * rounds,
        "quantize": sum(r["launches"] for r in bridge
                        if r["compressor"] == "qdither") + leaves * rounds,
        "dasha_mvr_update": sweep_launches["dasha_mvr_update"]}
    wall = time.perf_counter() - t0
    log(f"[p23] phase 23 in {wall:.1f} s ({walls}) | {smi}")
    return ({"bridge": bridge, "registry_trainer": trainer,
             "seed_api": seed, "sweeps": sweeps, "kernel_rows": rows,
             "launches": launches, "cuts": PHASE23_CUTS, "wall_s": wall,
             "walls_s": walls, "nvidia_smi": smi}, launches, rows)


def _mesh_smoke_calls(torch, cfg, params, tokens, cache, steps, exp=None):
    """The smoke serving calls of phase 24a: the last-position prefill
    logits through kernel 5 (``kernel_config``), then the decode steps;
    returns the outputs."""
    from repro_torch.launch.serve import kernel_config
    from repro_torch.models import lm
    outs = []
    with torch.no_grad():
        logits, _ = lm.forward(kernel_config(cfg), params, tokens,
                               last_only=True)
        outs.append(logits)
        for t in range(MESH_DECODE_STEPS):
            logits, cache = lm.decode_step(cfg, params, cache, steps[t], t)
            outs.append(logits)
    return outs


def _mesh_host(torch, smi: str):
    """Phase 24a: the smoke configs on ``make_host_mesh("cuda")`` against
    the same calls on plain tensors, bit for bit; returns (report, kernel
    5's launches in the sharded calls)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd_kern
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params, lm
    from repro_torch.models import sharding as sh
    rows, launches = [], 0
    B, S = MESH_SMOKE_BATCH, MESH_SMOKE_SEQ
    with M.enter_mesh(M.make_host_mesh("cuda")) as mesh:
        for arch in MESH_ARCHS:
            cfg = get_smoke_config(arch)
            params = init_params(cfg, 0, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(24)
            tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                                   device="cuda", dtype=torch.int32)
            steps = torch.randint(1, cfg.vocab_size, (MESH_DECODE_STEPS, B),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
            slots = S + MESH_DECODE_STEPS
            want = _mesh_smoke_calls(
                torch, cfg, params, tokens,
                lm.init_cache(cfg, B, slots, device="cuda"), steps)
            cache = lm.init_cache(cfg, B, slots, device="cuda")
            d_params = sh.distribute_tree(
                params, sh.param_specs(cfg, params, mesh), mesh)
            d_tokens = sh.distribute_tree(
                tokens, sh.batch_specs(cfg, mesh, B)["tokens"], mesh)
            d_cache = sh.distribute_tree(
                cache, sh.cache_specs(cfg, cache, mesh, B), mesh)
            d_steps = sh.distribute_tree(steps, sh.P(None, sh.dp_axes(mesh)),
                                         mesh)
            ssd_kern.reset_counts()
            with implicit_replication():
                got = _mesh_smoke_calls(torch, cfg, d_params, d_tokens,
                                        d_cache,
                                        [d_steps[t] for t in
                                         range(MESH_DECODE_STEPS)])
            torch.cuda.synchronize()
            n5 = ssd_kern.COUNTS["ssd_chunk"]
            want_n5 = cfg.num_layers if cfg.arch_type == "ssm" else 0
            if n5 != want_n5:
                raise AssertionError(f"[p24a] {arch}: kernel 5 launched {n5} "
                                     f"times in the sharded calls, expected "
                                     f"{want_n5}")
            launches += n5
            equal = [bool(torch.equal(g.full_tensor(), w))
                     for g, w in zip(got, want)]
            if not all(equal):
                raise AssertionError(f"[p24a] {arch}: sharded outputs differ "
                                     f"from the plain calls: {equal}")
            rows.append({"arch": arch, "outputs_bit_equal": len(equal),
                         "kernel5_launches": n5})
            log(f"[p24a] {arch} smoke on the 1x1 nccl mesh: prefill + "
                f"{MESH_DECODE_STEPS} decode steps bit-equal to the plain "
                f"calls, kernel 5 {n5} launches | {smi}")
        # planted: a DTensor at the kernel without local_map must raise
        x = sh.constrain(torch.zeros((1, 32, 2, 4), device="cuda"),
                         (None,) * 4, mesh)
        ssd_kern.reset_counts()
        try:
            ops.ssd_chunk_scan(x, x[..., 0], x[0, 0, :, 0], x[..., :2, 0],
                               x[..., :2, 0], x[0, 0, :, 0], 32)
        except ValueError as e:
            plant = str(e)
        else:
            raise AssertionError("[p24a] a DTensor reached kernel 5 without "
                                 "local_map and did not raise")
        if ssd_kern.COUNTS["ssd_chunk"]:
            raise AssertionError("[p24a] the planted call launched")
    return {"rows": rows, "plant_raised": plant[:200]}, launches


def _mesh_rank0(torch, out_path: str) -> None:
    """Phase 24b / 24c, run in its own process: the dry run of each of
    MESH_PAIRS on a fake ``cuda`` mesh, then rank 0's program of the pair
    on the card; writes the rows to ``out_path``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_chunk as ssd_kern
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.models import sharding as sh
    report = {}
    for arch, shape in MESH_PAIRS:
        t0 = time.perf_counter()
        row = dryrun.dryrun_one(arch, shape, device="cuda", verbose=False)
        row["dryrun_wall_s"] = time.perf_counter() - t0
        report[f"{arch} x {shape}"] = {"dryrun": row}
        if row["status"] != "ok":
            raise AssertionError(f"[p24c] {arch} x {shape}: {row}")
    for arch, shape in MESH_PAIRS:
        rec = report[f"{arch} x {shape}"]
        ref = rec["dryrun"]
        cfg = get_config(arch)
        with M.enter_mesh(M.make_production_mesh(device="cuda")) as mesh:
            spec = S.input_specs(cfg, shape, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device="cuda").manual_seed(24)

            def make_local(path, shape_, dtype):
                if dtype.is_floating_point:
                    return (0.02 * torch.randn(shape_, generator=gen,
                                               device="cuda")).to(dtype)
                return torch.randint(1, cfg.vocab_size, shape_,
                                     generator=gen, device="cuda",
                                     dtype=dtype)

            args = sh.distribute_tree(spec.args, spec.in_shardings, mesh,
                                      make_local=make_local)
            local = [x.to_local() for _, x in sh.leaves_with_path(args)
                     if sh.is_dtensor(x)]
            arg_bytes = sum(t.untyped_storage().nbytes() for t in local)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            ssd_kern.reset_counts()
            t0 = time.perf_counter()
            with implicit_replication():
                out = spec.fn(*args)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = ssd_kern.COUNTS["ssd_chunk"]
            peak = torch.cuda.max_memory_allocated() - base
            del out
            layers, fn, call_args = cfg.num_layers, spec.fn, args
            if first_s > MESH_CALL_CUT_S:
                layers = max(1, int(cfg.num_layers * MESH_CALL_CUT_S
                                    / first_s))
                cut = dataclasses.replace(cfg, num_layers=layers)
                fn = S.input_specs(cut, shape, mesh).fn
                cache_too = spec.static["kind"] == "decode"

                def cut_leaf(path, x, stacked):
                    return x[:layers] if sh.is_dtensor(x) and (
                        stacked or path[:1] == ("layers",)) else x
                # the stacked layer axis of the params and of the cache
                call_args = (
                    sh.map_with_path(functools.partial(cut_leaf,
                                                       stacked=False),
                                     args[0]),
                    sh.map_with_path(functools.partial(cut_leaf,
                                                       stacked=cache_too),
                                     args[1])) + tuple(args[2:])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with implicit_replication():
                out = fn(*call_args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            del out, args, call_args, local
        rec.update({
            "local_argument_bytes": arg_bytes,
            "argument_bytes_from_dryrun": ref["argument_gb"] * 1e9,
            "allocated_for_arguments_bytes": held,
            "peak_gb_above_baseline": peak / 1e9,
            "peak_ratio_to_dryrun": peak / 1e9 / ref["peak_gb"],
            "first_call_s": first_s, "ms_per_call": ms,
            "timed_layers": layers, "layers": cfg.num_layers,
            "cut": None if layers == cfg.num_layers else
            f"first call {first_s:.1f} s > {MESH_CALL_CUT_S} s: the timed "
            f"call at {layers} of {cfg.num_layers} layers, full width",
            "t_compute_ms": ref["t_compute_s"] * 1e3,
            "t_memory_ms": ref["t_memory_s"] * 1e3,
            "kernel5_launches": launches,
            "note": "fake collectives write nothing: outputs unchecked, no "
                    "collective term in the time"})
        gc.collect()
        torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(report, indent=1))


def phase_mesh(torch, smi: str):
    """Phase 24: the sharded serving programs (24a here; 24b and 24c in a
    subprocess).  Returns (report, kernel 5's launches by path)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host, host_launches = _mesh_host(torch, smi)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mesh_rank0.json"
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--mesh-rank0", str(out)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0 or not out.exists():
            raise AssertionError(
                f"[p24b] rank 0's subprocess failed (rc {run.returncode}): "
                f"{run.stderr[-3000:]}")
        rank0 = json.loads(out.read_text())
    launches = 0
    for name, rec in rank0.items():
        ref = rec["dryrun"]
        if rec["local_argument_bytes"] / 1e9 != ref["argument_gb"]:
            raise AssertionError(
                f"[p24b] {name}: local argument bytes "
                f"{rec['local_argument_bytes']} != the dry run's "
                f"{ref['argument_gb']} GB")
        lo, hi = MESH_PEAK_BAND
        if not lo <= rec["peak_ratio_to_dryrun"] <= hi:
            raise AssertionError(
                f"[p24b] {name}: peak {rec['peak_gb_above_baseline']:.3f} GB "
                f"is {rec['peak_ratio_to_dryrun']:.3f} x the dry run's "
                f"{ref['peak_gb']:.3f} GB, outside {MESH_PEAK_BAND}")
        want = rec["layers"] if name.startswith("mamba2") else 0
        if rec["kernel5_launches"] != want:
            raise AssertionError(f"[p24b] {name}: kernel 5 launched "
                                 f"{rec['kernel5_launches']} times in a "
                                 f"call, expected {want}")
        launches += rec["kernel5_launches"]
        log(f"[p24b] {name} rank 0 of 16x16 on the card: args "
            f"{rec['local_argument_bytes'] / 1e9:.4f} GB (= dry run), peak "
            f"{rec['peak_gb_above_baseline']:.3f} GB = "
            f"{rec['peak_ratio_to_dryrun']:.3f} x the dry run's "
            f"{ref['peak_gb']:.3f}; {rec['ms_per_call']:.2f} ms a call "
            f"({rec['timed_layers']}/{rec['layers']} layers"
            f"{'; ' + rec['cut'] if rec['cut'] else ''}) vs the roofline's "
            f"per-chip compute {rec['t_compute_ms']:.3f} ms, memory "
            f"{rec['t_memory_ms']:.3f} ms; kernel 5 {rec['kernel5_launches']}"
            f" a call; {rec['note']} | {smi}")
        log(f"[p24c] {name}: dryrun_one in {ref['dryrun_wall_s']:.1f} s "
            f"(trace {ref['trace_s']} s), peak {ref['peak_gb']:.3f} GB a "
            f"device, collectives {ref['coll_detail']}")
    wall = time.perf_counter() - t0
    log(f"[p24] phase 24 in {wall:.1f} s | {smi}")
    return ({"host_mesh": host, "rank0": rank0, "cuts": PHASE24_CUTS,
             "wall_s": wall, "nvidia_smi": smi},
            {"mesh_host": host_launches, "mesh_rank0": launches})


def _mesh_train_batch(torch, cfg, lead, seq, gen):
    tokens = torch.randint(1, cfg.vocab_size, lead + (seq,), generator=gen,
                           device="cuda", dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, -1)}


def _mesh_train_host(torch, smi: str):
    """Phase 25a: the smoke trainers of MESH_TRAIN_CASES through
    ``train_spec``'s step on ``make_host_mesh("cuda")``'s DTensors against
    the same step on plain tensors on the card, bit for bit, on injected
    masks; kernel 3 (DASHA-MVR) or kernel 1's sparsifier entry (DASHA)
    counted through ``local_map``.  Returns (report, each kernel's
    launches in the sharded rounds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.models import init_params
    from repro_torch.models import sharding as sh
    from repro_torch.optim.distributed import (DashaTrainConfig,
                                               dasha_train_init)
    rows = []
    launches = {k: 0 for k in MESH_TRAIN_KERNEL.values()}
    R = MESH_TRAIN_ROUNDS
    with M.enter_mesh(M.make_host_mesh("cuda")) as mesh:
        for arch, variant in MESH_TRAIN_CASES:
            t0 = time.perf_counter()
            kernel = MESH_TRAIN_KERNEL[variant]
            cfg = get_smoke_config(arch)
            spec = S.train_spec(cfg, mesh, seq=MESH_TRAIN_SEQ,
                                global_batch=MESH_TRAIN_BATCH,
                                dasha=DashaTrainConfig(
                                    gamma=0.01, compression=0.5,
                                    variant=variant, use_kernel=True))
            dcfg = DashaTrainConfig(**spec.static["dasha"])
            params = init_params(cfg, 0, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(25)
            batch = _mesh_train_batch(torch, cfg, (1, MESH_TRAIN_BATCH),
                                      MESH_TRAIN_SEQ, gen)
            want = dasha_train_init(params, dcfg, 0, device="cuda")
            draws = [Draws(masks=tree.map_leaves(
                lambda h: (torch.rand(h.shape, generator=gen, device="cuda")
                           < 0.5).to(torch.float32), want.h_local))
                for _ in range(R)]
            wm = []
            for d in draws:
                want, m = spec.fn(want, batch, draws=d)
                wm.append(m)
            state = dasha_train_init(params, dcfg, 0, mesh=mesh,
                                     specs=spec.in_shardings[0])
            d_batch = sh.distribute_tree(batch, spec.in_shardings[1], mesh)
            torch.cuda.synchronize()
            _reset_launch_counts()
            gm = []
            with implicit_replication():
                for d in draws:
                    state, m = spec.fn(state, d_batch, draws=d)
                    gm.append(m)
            torch.cuda.synchronize()
            counts = _launch_counts()
            leaves = len(tree.leaves(params))
            _gate_launches(f"p25a {arch} {variant}", counts,
                           {kernel: leaves * R})
            launches[kernel] += leaves * R
            unequal = [f"{f}/{p}" for f in ("params", "g", "h_local",
                                             "g_local")
                       for (p, x), (_, w) in zip(
                           tree.items(getattr(state, f)),
                           tree.items(getattr(want, f)))
                       if not torch.equal(x.full_tensor(), w)]
            metrics_equal = all(
                torch.equal(a["g_norm_sq"].full_tensor(), b["g_norm_sq"])
                and float(a["payload_coords"]) == float(b["payload_coords"])
                for a, b in zip(gm, wm))
            if unequal or not metrics_equal:
                raise AssertionError(f"[p25a] {arch} {variant}: the sharded "
                                     f"rounds differ from the plain ones: "
                                     f"{unequal[:8]}, metrics "
                                     f"{metrics_equal}")
            rows.append({"arch": arch, "variant": variant, "leaves": leaves,
                         "rounds": R, "state_leaves_bit_equal": 4 * leaves,
                         "kernel": kernel, "launches": leaves * R,
                         "wall_s": time.perf_counter() - t0})
            log(f"[p25a] {arch} smoke trainer on the 1x1 nccl mesh: {R} "
                f"rounds of {variant} bit-equal to the plain-tensor "
                f"trainer ({4 * leaves} state leaves and the metrics), "
                f"{kernel} {leaves * R} launches through local_map | {smi}")
        plants = {}
        # planted: a DTensor at kernel 3 without local_map must raise
        x = sh.constrain(torch.zeros((1, 8), device="cuda"), (None, None),
                         mesh)
        _reset_launch_counts()
        try:
            ops.dasha_mvr_update(x, x, x, x, x, 0.1, 0.1, 1.0)
        except ValueError as e:
            plants["dtensor_at_kernel"] = str(e)[:200]
        else:
            raise AssertionError("[p25a] a DTensor reached kernel 3 without "
                                 "local_map and did not raise")
        # planted: a mask laid out otherwise than h (its node axis
        # replicated where h's lies over "data") must be refused
        h = sh.distribute_tree(torch.zeros((1, 8), device="cuda"),
                               sh.P(("data",), None), mesh)
        mask = sh.distribute_tree(torch.ones((1, 8), dtype=torch.bool,
                                             device="cuda"),
                                  sh.P(None, None), mesh)
        try:
            ops.dasha_mvr_update_sharded(h, h, h, h, mask, 0.1, 0.1, 1.0)
        except Exception as e:
            plants["mask_layout"] = f"{type(e).__name__}: {str(e)[:200]}"
        else:
            raise AssertionError("[p25a] a mask laid out otherwise than h "
                                 "reached kernel 3")
        torch.cuda.synchronize()
        if sum(_launch_counts().values()):
            raise AssertionError(f"[p25a] a planted call launched: "
                                 f"{_launch_counts()}")
    return {"rows": rows, "plants": plants}, launches


def _cut_train_args(sh, args, layers: int):
    """The train step's (state, batch) with every stacked layer axis cut
    to its first ``layers``: dim 0 of the parameters' and g's ``layers``
    leaves, dim 1 of the per-node ones'."""
    def cut(path, x):
        if not sh.is_dtensor(x) or len(path) < 2 or path[1] != "layers":
            return x
        if path[0] in ("h_local", "g_local"):
            return x[:, :layers]
        return x[:layers]
    return (sh.map_with_path(cut, args[0]),) + tuple(args[1:])


def _mesh_train_config():
    from repro_torch.optim.distributed import DashaTrainConfig
    return DashaTrainConfig(gamma=0.01, compression=1 / 32, variant="mvr",
                            use_kernel=True)


def _mesh_train_rank0(torch, out_path: str) -> None:
    """Phase 25b / 25c, run in its own process after phase 24, one step
    after the other: the dry run of each of MESH_TRAIN_PAIRS on a fake
    ``cuda`` 16 x 16 mesh (25c), then rank 0's training rounds of each
    pair on the card (25b; a pair the dry run reckons above
    MESH_TRAIN_FIT_GB is recorded and not run); writes the rows to
    ``out_path``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.models import sharding as sh
    dc = _mesh_train_config()
    report = {}
    for arch, shape in MESH_TRAIN_PAIRS:
        t0 = time.perf_counter()
        row = dryrun.dryrun_one(arch, shape, dasha=dc, device="cuda",
                                verbose=False)
        row["dryrun_wall_s"] = time.perf_counter() - t0
        report[f"{arch} x {shape}"] = {"dryrun": row}
        if row["status"] != "ok":
            raise AssertionError(f"[p25c] {arch} x {shape}: {row}")
    for arch, shape in MESH_TRAIN_PAIRS:
        rec = report[f"{arch} x {shape}"]
        ref = rec["dryrun"]
        if ref["peak_gb"] > MESH_TRAIN_FIT_GB:
            rec["skipped"] = (f"the dry run reckons rank 0's peak at "
                              f"{ref['peak_gb']:.2f} GB, above "
                              f"{MESH_TRAIN_FIT_GB} GB")
            continue
        cfg = get_config(arch)
        with M.enter_mesh(M.make_production_mesh(device="cuda")) as mesh:
            spec = S.input_specs(cfg, shape, mesh, dasha=dc)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device="cuda").manual_seed(25)

            def make_local(path, shape_, dtype):
                if dtype.is_floating_point:
                    return (0.02 * torch.randn(shape_, generator=gen,
                                               device="cuda")).to(dtype)
                return torch.randint(1, cfg.vocab_size, shape_,
                                     generator=gen, device="cuda",
                                     dtype=dtype)

            args = sh.distribute_tree(spec.args, spec.in_shardings, mesh,
                                      make_local=make_local)
            local = [x.to_local() for _, x in sh.leaves_with_path(args)
                     if sh.is_dtensor(x)]
            arg_bytes = sum(t.untyped_storage().nbytes() for t in local)
            leaves = len(tree.leaves(args[0].params))
            biggest = max(h.to_local().numel()
                          for h in tree.leaves(args[0].h_local))
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            _reset_launch_counts()
            t0 = time.perf_counter()
            with implicit_replication():
                out = spec.fn(*args)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            warm = dict(_launch_counts())
            peak = torch.cuda.max_memory_allocated() - base
            del out
            _gate_launches(f"p25b {arch} warm-up", warm,
                           {"dasha_mvr_update": leaves})
            layers, fn, call_args = cfg.num_layers, spec.fn, args
            if first_s > MESH_CALL_CUT_S:
                layers = max(1, int(cfg.num_layers * MESH_CALL_CUT_S
                                    / first_s))
                cut = dataclasses.replace(cfg, num_layers=layers)
                fn = S.input_specs(cut, shape, mesh, dasha=dc).fn
                call_args = _cut_train_args(sh, args, layers)
            _reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MESH_TRAIN_TIMED):
                with implicit_replication():
                    out = fn(*call_args)
                del out
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / MESH_TRAIN_TIMED
            timed = dict(_launch_counts())
            _gate_launches(f"p25b {arch} timed", timed,
                           {"dasha_mvr_update": leaves * MESH_TRAIN_TIMED})
            busy = None
            if arch in MESH_TRAIN_PROFILED:
                # one more round, after the timed one, under the profiler
                # (device activity only): the device's busy share
                _reset_launch_counts()

                def one_round():
                    with implicit_replication():
                        return fn(*call_args)
                table, pwall = profiled(torch, one_round, cpu=False)
                _gate_launches(f"p25b {arch} profiled", _launch_counts(),
                               {"dasha_mvr_update": leaves})
                timed["dasha_mvr_update"] += leaves
                dev_s = sum(t for _, t in table.values()) / 1e6
                busy = {"wall_s": pwall, "device_busy_s": dev_s,
                        "busy_share": dev_s / pwall,
                        "device_launches": sum(c for c, _ in table.values()),
                        "top": sorted(((round(t / 1e3, 3), c, k[:90])
                                       for k, (c, t) in table.items()),
                                      reverse=True)[:8]}
            del args, call_args, local
        rec.update({
            "local_argument_bytes": arg_bytes,
            "argument_bytes_from_dryrun": ref["argument_gb"] * 1e9,
            "allocated_for_arguments_bytes": held,
            "peak_gb_above_baseline": peak / 1e9,
            "peak_ratio_to_dryrun": peak / 1e9 / ref["peak_gb"],
            "first_round_s": first_s, "ms_per_round": ms,
            "timed_rounds": MESH_TRAIN_TIMED,
            "timed_layers": layers, "layers": cfg.num_layers,
            "cut": None if layers == cfg.num_layers else
            f"warm-up round {first_s:.1f} s > {MESH_CALL_CUT_S} s: the "
            f"timed round at {layers} of {cfg.num_layers} layers, full "
            "width",
            "t_compute_ms": ref["t_compute_s"] * 1e3,
            "t_memory_ms": ref["t_memory_s"] * 1e3,
            "leaves": leaves, "largest_leaf_shard": biggest,
            "kernel3_launches": warm["dasha_mvr_update"]
            + timed["dasha_mvr_update"],
            "rounds": 1 + MESH_TRAIN_TIMED + (busy is not None),
            "profile": busy,
            "note": "fake collectives write nothing: outputs unchecked, no "
                    "collective term in the time"})
        gc.collect()
        torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(report, indent=1))


def phase_mesh_train(torch, smi: str):
    """Phase 25: the sharded DASHA trainer: 25a here, then 25c and 25b one
    after the other in a subprocess (a process group is global to its
    process), nothing else running.  Returns (report, kernel 1's and
    kernel 3's launches by path, kernel 3's rows at the largest leaf shard
    of each 25b pair)."""
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host, host_launches = _mesh_train_host(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mesh_train_rank0.json"
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--mesh-train-rank0", str(out)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0 or not out.exists():
            raise AssertionError(
                f"[p25b] rank 0's subprocess failed (rc {run.returncode}): "
                f"{run.stderr[-3000:]}")
        rank0_rows = json.loads(out.read_text())
    launches, rows = 0, []
    for name, rec in rank0_rows.items():
        ref_row = rec["dryrun"]
        log(f"[p25c] {name}: dryrun_one in {ref_row['dryrun_wall_s']:.1f} s "
            f"(trace {ref_row['trace_s']} s), peak {ref_row['peak_gb']:.3f} "
            f"GB a device, collectives {ref_row['coll_detail']}")
        if "skipped" in rec:
            log(f"[p25b] {name} not run on the card: {rec['skipped']}")
            continue
        if rec["local_argument_bytes"] / 1e9 != ref_row["argument_gb"]:
            raise AssertionError(
                f"[p25b] {name}: local argument bytes "
                f"{rec['local_argument_bytes']} != the dry run's "
                f"{ref_row['argument_gb']} GB")
        lo, hi = MESH_PEAK_BAND
        if not lo <= rec["peak_ratio_to_dryrun"] <= hi:
            raise AssertionError(
                f"[p25b] {name}: peak {rec['peak_gb_above_baseline']:.3f} GB "
                f"is {rec['peak_ratio_to_dryrun']:.3f} x the dry run's "
                f"{ref_row['peak_gb']:.3f} GB, outside {MESH_PEAK_BAND}")
        launches += rec["kernel3_launches"]
        log(f"[p25b] {name} rank 0 of 16x16 on the card: args "
            f"{rec['local_argument_bytes'] / 1e9:.4f} GB (= dry run), peak "
            f"{rec['peak_gb_above_baseline']:.3f} GB = "
            f"{rec['peak_ratio_to_dryrun']:.3f} x the dry run's "
            f"{ref_row['peak_gb']:.3f}; warm-up {rec['first_round_s']:.2f} "
            f"s, {rec['ms_per_round']:.2f} ms a round "
            f"({rec['timed_layers']}/{rec['layers']} layers"
            f"{'; ' + rec['cut'] if rec['cut'] else ''}) vs the roofline's "
            f"per-chip compute {rec['t_compute_ms']:.3f} ms, memory "
            f"{rec['t_memory_ms']:.3f} ms (the dry run's DASHA rows); kernel "
            f"3 {rec['leaves']} a round ({rec['kernel3_launches']} in "
            f"{rec['rounds']} rounds); {rec['note']} | {smi}")
        if rec["profile"]:
            pr = rec["profile"]
            log(f"[p25b] {name}: a profiled round (device activity only) "
                f"{pr['wall_s']:.3f} s, device busy {pr['device_busy_s']:.3f}"
                f" s = {pr['busy_share']:.3f} of it, {pr['device_launches']} "
                f"kernels; the longest {pr['top'][:4]} | {smi}")
        shard = (1, rec["largest_leaf_shard"])
        row = _check_mvr(torch, kern, ref, shard, False, 2500 + len(rows))
        row.update({"shape": list(shard), "path": f"25b {name}: the "
                    "largest leaf's rank-0 shard"})
        rows.append(row)
        log(f"[p25b] kernel 3 at {name}'s largest leaf shard {shard}: "
            f"bit-equal to its plain version, {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"{row['bound_by']}) | {smi}")
    wall = time.perf_counter() - t0
    log(f"[p25] phase 25 in {wall:.1f} s | {smi}")
    return ({"host_mesh": host, "rank0": rank0_rows, "cuts": PHASE25_CUTS,
             "wall_s": wall, "nvidia_smi": smi},
            {"dasha_mvr_update": {
                "mesh_train_host": host_launches["dasha_mvr_update"],
                "mesh_train_rank0": launches},
             "dasha_sparsify_update": {
                 "mesh_train_host": host_launches["dasha_sparsify_update"]}},
            rows)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
              "repository", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mesh-rank0"]:      # phase 24b / 24c's process
        _mesh_rank0(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--mesh-train-rank0"]:   # phase 25b / 25c's
        _mesh_train_rank0(torch, sys.argv[2])
        return 0
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    walls = {}

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        walls[fn.__name__] = time.perf_counter() - t0
        log(f"[main] {fn.__name__} in {walls[fn.__name__]:.1f} s")
        return res

    timed(phase_build)
    per_shape = timed(phase_kernels, torch)
    kernel2 = timed(phase_kernel2, torch)
    per_shape["quantize"] = kernel2["quantize"]
    sparsify = timed(phase_sparsify, torch)
    runs, launches = timed(phase_main_path, torch)
    rel = timed(phase_agreement, torch)
    trainer, train_launches = timed(phase_trainer, torch)
    launches["dasha_mvr_update"] = train_launches["dasha_mvr_update"]
    train_rel = timed(phase_trainer_agreement, torch)
    ssd_rows = timed(phase_ssd_kernel, torch, smi)
    serving, launches["ssd_chunk"] = timed(phase_serve, torch, smi)
    serve_rel = timed(phase_serve_agreement, torch)
    slab_rows = timed(phase_slab_kernel, torch, smi)
    # the paths' own kernel-1 rows join the sparsifier entry's cases
    fed, fed_launches, fed_dasha = timed(phase_fed_main, torch, smi)
    sparsify["cases"].append(fed_dasha)
    fed_rel = timed(phase_fed_agreement, torch)
    heap, heap_launches = timed(phase_heap, torch, smi)
    sweep, sweep_launches, sweep_dasha = timed(phase_sweep, torch, smi)
    sparsify["cases"].append(sweep_dasha)
    faults, fault_launches, fault_rows = timed(phase_faults, torch, smi)
    sparsify["cases"].append(fault_rows["dasha_sparsify_update"])
    per_shape["quantize"].append(fault_rows["quantize"])
    asyncr, async_launches = timed(
        phase_async, torch, smi, fault_peak_gb=faults["peak_mem_gb"],
        fed_peak_gb=fed["peak_mem_gb"])
    obsr, obs_launches = timed(phase_obs, torch, smi)
    ckpt, ckpt_launches = timed(phase_ckpt, torch, smi)
    dense, dense_launches = timed(phase_dense, torch, smi)
    family, family_launches = timed(phase_family, torch, smi)
    hybrid, hybrid_launches, hybrid_ssd_rows = timed(phase_hybrid, torch, smi)
    ssd_rows.extend(hybrid_ssd_rows)
    cross, cross_launches = timed(phase_cross, torch, smi)
    registry, p23_launches, p23_rows = timed(phase_registry, torch, smi)
    mesh, mesh_launches = timed(phase_mesh, torch, smi)
    mesh_train, mesh_train_launches, mesh_train_rows = timed(
        phase_mesh_train, torch, smi)
    per_shape["dasha_mvr_update"].extend(mesh_train_rows)
    sparsify["cases"].append(p23_rows["dasha_sparsify_update"])
    per_shape["dasha_mvr_update"].append(p23_rows["dasha_mvr_update"])
    kernel2["fused"].append(p23_rows["dasha_quantize_update"])
    # kernels 1 to 4 run on several main paths: the flat round, the
    # federated cohort round, the heap oracle, the sweep, the faulted
    # campaigns, the asynchronous ones, the runs with an observability
    # handle, the checkpoint drills and phase 25a's sharded DASHA trainer
    # through local_map; kernel 3 in the trainers (Mamba2,
    # starcoder2, the phase-20 families, zamba2, the VLM's smoke config and
    # whisper-tiny), the drill and phase 25's sharded trainers through
    # local_map; kernel 5 in the Mamba2 and zamba2
    # prefills and phase 24's sharded prefills through local_map (each
    # counted from zero around its own run)
    by_path = {
        "dasha_sparsify_update": {
            "flat": launches["dasha_sparsify_update"],
            "fed": fed_launches["dasha_sparsify_update"],
            "heap": heap_launches["dasha_sparsify_update"],
            "sweep": sweep_launches,
            "faults": fault_launches["dasha_sparsify_update"],
            "async": async_launches["dasha_sparsify_update"],
            "obs": obs_launches["dasha_sparsify_update"],
            "ckpt": ckpt_launches["dasha_sparsify_update"],
            "registry": p23_launches["dasha_sparsify_update"],
            **mesh_train_launches["dasha_sparsify_update"]},
        "dasha_mvr_update": {"trainer": launches["dasha_mvr_update"],
                             "ckpt": ckpt_launches["dasha_mvr_update"],
                             "dense_trainer": dense_launches,
                             "family_trainer": family_launches,
                             "hybrid_trainer":
                                 hybrid_launches["dasha_mvr_update"],
                             **cross_launches,
                             "registry": p23_launches["dasha_mvr_update"],
                             **mesh_train_launches["dasha_mvr_update"]},
        "ssd_chunk": {"mamba2_prefill": launches["ssd_chunk"],
                      "hybrid": hybrid_launches["ssd_chunk"],
                      **mesh_launches},
        "quantize": {"flat": launches["quantize"],
                     "heap": heap_launches["quantize"],
                     "faults": fault_launches["quantize"],
                     "async": async_launches["quantize"],
                     "obs": obs_launches["quantize"],
                     "registry": p23_launches["quantize"]},
        "slab_writeback": {"fed": fed_launches["slab_writeback"],
                           "heap": heap_launches["slab_writeback"],
                           "async": async_launches["slab_writeback"],
                           "obs": obs_launches["slab_writeback"],
                           "ckpt": ckpt_launches["slab_writeback"]}}
    for name, paths in by_path.items():
        launches[name] = sum(paths.values())

    sources = {"dasha_update": "src/repro/kernels/dasha_update.py:70",
               "dasha_mvr_update": "src/repro/kernels/dasha_update.py:90",
               "quantize": "src/repro/kernels/dasha_update.py:129"}
    # the row each kernel reports: the flat path's (5, 20958); for the MVR
    # kernel the trainer's largest leaf, the tied embedding (4, 77463552)
    headline = {"dasha_update": 0, "quantize": 0, "dasha_mvr_update": 1}
    kernels = []
    for name, rows in per_shape.items():
        main_shape = rows[headline[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dasha_update.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "shapes": rows})
        if name == "quantize":
            kernels[-1]["launch_floor_ms"] = kernel2["launch_floor_ms"]
            kernels[-1]["turns"] = kernel2["turns"]
            kernels[-1]["launches_by_path"] = by_path["quantize"]
        if name == "dasha_mvr_update":
            kernels[-1]["per_round"] = {
                k: trainer[k] for k in ("kernel_device_ms_per_round",
                                        "kernel_bound_ms_per_round",
                                        "kernel_share_of_profiled_round")}
    # kernel 2's fused QDither entry, its own row at the flat round's (5,
    # 20958): 24 bytes an element, against the chain it replaces (the
    # reference's jnp drift, scale and add around quantize_pallas).  Every
    # main path reaches kernel 2 through this entry only (phase 3's profile
    # gates it), so its launches are kernel 2's "quantize" count
    main_shape = kernel2["fused"][0]
    kernels.append({
        "name": "dasha_quantize_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dasha_update.cu",
        "replaces": "src/repro/kernels/dasha_update.py:129",
        "replaces_chain": "src/repro/compress/backends.py:152",
        "launches": launches["quantize"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel2["fused"]),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "launches_by_path": by_path["quantize"], "shapes": kernel2["fused"]})
    # kernel 1's sparsifier entry, its own row at the flat round's (5,
    # 20958) RandK: 20 bytes an element and the plan's indices, against the
    # chain it replaces (the reference's jnp mask build around
    # dasha_update_pallas).  Every main path reaches kernel 1 through this
    # entry (phase 3's profile and every launch gate hold it), so the
    # dense-mask row above reports the dense-mask entry's own launches: none
    main_shape = sparsify["cases"][0]
    kernels.append({
        "name": "dasha_sparsify_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dasha_update.cu",
        "replaces": "src/repro/kernels/dasha_update.py:70",
        "replaces_chain": "src/repro/compress/backends.py:158-172",
        "launches": launches["dasha_sparsify_update"],
        "max_abs_err": max(r["max_abs_err"] for r in sparsify["cases"]),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "device_ms": main_shape["device_ms"],
        "launches_by_path": by_path["dasha_sparsify_update"],
        "turns": sparsify["turns"],
        "shapes": sparsify["cases"]})
    # the SSD kernel's row: one layer of the serving prefill in bf16; its
    # bound is that of the tensor-core arithmetic it runs, with the float32
    # CUDA-core bound of the same work beside it; zamba2's shape (phase 21d)
    # is the last of its shapes
    main_shape = ssd_rows[0]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:62",
        "launches": launches["ssd_chunk"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["tc_bound_ms"],
        "bound_by": main_shape["tc_bound_by"], "library_ms": None,
        "float32_bound_ms": main_shape["bound_ms"],
        "float32_bound_by": main_shape["bound_by"],
        "device_ms": main_shape["device_ms"],
        "sass_mma": main_shape["sass_mma"], "shapes": ssd_rows,
        # its device time in the profiled 48-layer prefill call (phase 8a)
        "per_layer": {k: serving["prefill"][k] for k in (
            "ssd_chunk_profiled_launches", "ssd_chunk_device_ms_per_layer",
            "ssd_chunk_bound_ms_per_layer", "ssd_chunk_tc_bound_ms_per_layer",
            "ssd_chunk_share_of_call")},
        # and in the profiled 7-layer zamba2 prefill (phase 21a)
        "per_layer_hybrid": {k: hybrid["serve"]["prefill"]["profile"][k]
                             for k in ("ssd_chunk_launches",
                                       "ssd_chunk_device_ms_per_layer",
                                       "ssd_chunk_bytes_bound_ms_per_layer",
                                       "ssd_chunk_tc_bound_ms_per_layer")}})
    # the slab kernel's row: the cell's chunk slab, set
    main_shape = slab_rows[0]
    kernels.append({
        "name": "slab_writeback", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slab_writeback.cu",
        "replaces": "src/repro/kernels/slab_writeback.py:38",
        "launches": launches["slab_writeback"],
        "max_abs_err": max(r["max_abs_err"] for r in slab_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"], "shapes": slab_rows,
        # its device time in phase 11's profiled chunk (two launches)
        "per_chunk": {k: fed["profiled_chunk"][k] for k in (
            "slab_writeback_launches", "slab_writeback_device_ms",
            "slab_writeback_bound_ms", "union_rows")}})
    # every kernel of the main paths launched there: kernel 1 through its
    # sparsifier entry; its dense-mask entry, the Pallas entry's
    # counterpart, is on no path, and must not have launched on one
    for row in kernels:
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
        row["on_main_path"] = row["name"] not in OFF_PATH_ENTRIES
        if not row["on_main_path"] and row["launches"]:
            raise AssertionError(f"{row['name']} launched on a main path "
                                 f"({row['launches']} times)")
        if row["on_main_path"] and row["launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on the "
                                 "main path")
    report = {"kernels": kernels, "main_path": runs,
              "agreement_max_rel_err": rel, "trainer": trainer,
              "trainer_agreement_worst": train_rel, "serve": serving,
              "serve_agreement_worst": serve_rel, "fed": fed,
              "fed_agreement_worst": fed_rel, "heap": heap,
              "sweep": sweep, "faults": faults, "async": asyncr,
              "obs": obsr, "ckpt": ckpt, "dense": dense,
              "family": family, "hybrid": hybrid, "cross": cross,
              "registry": registry, "mesh": mesh,
              "mesh_train": mesh_train,
              "phase22_cuts": PHASE22_CUTS, "phase23_cuts": PHASE23_CUTS,
              "phase24_cuts": PHASE24_CUTS, "phase25_cuts": PHASE25_CUTS,
              "phase_walls_s": walls,
              "nvidia_smi": smi}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
