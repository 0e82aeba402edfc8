#!/usr/bin/env python3
"""Smoke run of sparse_dot_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card and build: the card's name and power limit, torch and CUDA
   versions; the hand kernels (``sparse_dot_tpu_torch/csrc``) built with
   one nvcc per source for sm_90a, all started together, with the
   build's seconds;
2. each kernel against its plain PyTorch version on the card, for every
   value type and both index widths, at rtol 1e-12 (f64, c128) and 1e-5
   (f32, c64) with atol = rtol * max|plain|: the two sum in different
   orders, neither uses plain TF32.  K2 CSR SpMM at n in {1, 2, 3, 4, 8,
   16, 17, 32, 64, 128, 200} (16-byte loads and scalar ones, odd n on the
   scalar path), on B views one row and one element into a buffer (the
   latter misaligned, so scalar), and K3 CSR SpMV, both with empty rows,
   nnz == 0 and a row at least 3x K2's chunk and K3's tile (split, summed
   in chunk order; run twice, same bits).  K1 BSR SpMM in both
   variants: the tensor-core one (bs in {8, 16, 24, 64, 128, 256}, every
   value type, complex values on its complex instances) and the
   CUDA-core one (bs in {1, 3}), at n in {1, 37, 64, 256}, with empty
   block rows, no stored block, a block row at least 3x the chunk
   length (split and summed; run twice,
   same bits), f32 values log-uniform over 1e-3..1e3 (plain TF32 would
   fail) and inf in A and B (complex values too, -inf in imaginary parts,
   with alpha, beta and C0); each call's variant is checked by the
   per-variant launch counts.  K2 and K3 on complex values with inf in A
   and in B against scipy (the same inf/nan parts).  K4 + K5 (sparse x
   sparse, count then fill) against the plain expand-sort-compress with
   equal counts, indptr and indices, and K6 (dense output) against its
   plain version, with and without ``triangular`` and the epilogue, over
   op(B) with its rows sorted (entered by search) and shuffled (sorted by
   the wrapper first), each run twice for the same bits, and over
   shuffled rows that the caller wrongly calls sorted (no write may leave
   the work item's columns) (K4 + K5's second run with the plan built in
   K4's launch, equal to ``spgemm_plan``'s), in shapes that put rows in
   every accumulator bin (the register bins of 4, 8, 16 and 32 lanes,
   the sorted-product bins of a warp, hash tables of a block, a dense row
   in shared memory, and in the device workspace) and K6 on every kind of
   launch plan (a row split across warps or a warp's own, whole or cut
   into column windows):
   narrow n, runs of one column, exactly cancelled sums, op(A) rows longer
   than a group over empty op(B) rows, rows of 2000 entries, 6000 short
   rows, and n on either side of 2^27, where the register bins' sort keys
   widen to 64 bits.  K7 CSR SDDMM (the value gradient) against its plain
   version at n in {1, 2, 3, 4, 8, 17, 32, 64, 128, 130, 200, 300}, with
   and without alpha, on G and B views one row and one element into a
   buffer, with empty rows, nnz == 0, a row of 100,000 entries, rows of
   0.05 entries on average and a run of 6000 empty rows (every call run
   twice, same bits), and with inf in G and B (the same inf/nan parts),
   each path (the entry kernel and the span kernel with rounds of 2 and
   4 entries; 16-byte and scalar loads; 32- and 64-bit indices) and each
   edge of its work split (K7_EDGES: nnz past a whole round or span, a
   span across 1000 empty rows, a row longer than a span, a strip ending
   mid-row, misaligned views on scalar loads) seen.  K6 on the op(B)
   whose rows repeat a column that ROADMAP's fault 1 names: the same
   ``ValueError`` on the CPU and on the card, raw and tracked, and no
   launch.  K8 block SDDMM (BSR SpMM's gradient in the blocks) in both
   variants (bs % 8 == 0 on the tensor cores in every value type, the
   rest on the CUDA cores; each call's variant checked by the
   per-variant counts) against its plain version at bs in
   {1, 3, 8, 16, 24, 64, 128} and n in {1, 37, 64, 256}, with and
   without alpha, on G and B and on
   views of them one row into a buffer, with empty block rows and no
   stored block, and with inf in G and B at bs 3, 8 and 64; K9, the
   sampled sparse-row product (the dense-output SpGEMM's value
   gradients), against its plain versions in both forms (dA: D's rows;
   dB: D's columns), with empty rows of P and of Y, a row of Y of 2000
   entries, 6000 short rows of P, no entry, and inf, on groups of 1 to 32
   lanes, with D's lines staged in shared memory (panels of 4 to 32
   lines) and read in place; every K8 and K9 call run twice for the
   same bits.  K11, the sparse-output product's value gradients, against
   its plain version in both forms (dA: op(A)'s entries; dB: op(B)'s),
   with and without ``triangular``, on C made by K4 + K5: empty rows of
   op(A) and op(B), no entry of either, 6000 short rows, lines of G
   staged and read in place in each form, each with a row of C of over
   2000 entries (``K11_MODES``), under the budgets of ``K11_BUDGETS``,
   groups of 1 to 32 lanes staged and in place, inf in
   G, and a C that lacks some products' entries with inf and nan in Y
   (those products add nothing), every call run twice for the same bits
   (``check_k11_all``).  The batched launches (``check_batched``): K2,
   K7, K1 and K8 (each variant) with a batch of members that share the
   pattern, against their batched plain versions in every value type,
   with shared and batched operands (``SPMM_COMBOS``, ``SDDMM_COMBOS``;
   K7 with B shared on 2 and 4 members a group, with G shared also with
   the roles swapped on A's transpose, every such count seen),
   alpha, beta and c0, members at odd strides (not on 16 bytes: the
   scalar path), K2 and K7 over a row past 3x K2's chunk and K1 over a
   split block row (each member with its own counts, partial rows and
   workspace slots), every call twice for the same bits, and a batch of
   70,000 tiny members through each (two launches: the grid holds
   65,535 a launch); and the sparse x sparse ones
   (``check_batched_spgemm``): K5, K6, K9 (both forms) and K11 (both
   forms) against their batched plain versions in every value type and
   both index widths, with shared and per-member operands at odd member
   strides, with and without ``triangular``, K6 with and without the
   alpha/beta/c0 epilogue over sorted and shuffled op(B) on split rows
   and column windows, K5 on every row bin (its indices equal the single
   product's), K9 and K11 staged and in place, each call twice for the
   same bits, and 70,000 members each (two launches); K9 and K11 with a
   group of members a block (``check_grouped_sampled``): the rule's
   choice, which the inputs lead to 4 and 2 members a group and to one
   member a block, in every value type and both index widths, at 3 and 5
   members (a last group part full), D (G) and Y's values shared or per
   member at odd strides, rows of Y held in registers and longer ones,
   every call twice for the same bits; K2 and K5 with a group of members
   a block (``check_groups``): K2 with b shared and per-member values in
   f32, f64 and c128 with 32- and 64-bit indices, n in {1, 17, 64, 128},
   batches of 1, 3, 4, 5 (at odd member strides) and 16, alpha / beta
   with c0 per member or shared and none, over empty rows and a row past
   3x the chunk (split), each call's group launches counted
   (``csr_spmm.launches_group``) and each member against its single
   launch, bit for bit where the two take one lane mapping; K5 in the
   same types and batches over the register bins, the sorted-product
   bins, hash tables of a block, a dense row in shared memory and dense
   rows in the device workspace (one member a block), with and without
   ``triangular``, op(A)'s, op(B)'s or both values per member, each
   member's values bit for bit its single fill's; K6 at 2 and 4 members
   a block (``check_k6_groups``) in every value type and both index
   widths, op(A)'s, op(B)'s, both or only c0's values per member, split
   rows and column windows with and without the window-start table, with
   and without ``triangular``, batches of 2, 3 and 5, each member bit for
   bit its single launch on the single plan and on the group's; K1 on
   the tensor cores at 2 and 4 members a block (``check_k1_groups``) in
   f32 and f64, bs 8 to 128, a split block row, n 37 and 64, c0 none, shared or per member, odd member strides,
   each member bit for bit its single launch; every call twice for the
   same bits.  K12 CSR densify
   (``check_k12``) against its plain version in every value type and
   index width: repeated and unsorted columns, explicit zeros, empty
   rows, no entry, m or k = 1, an odd width, rows exactly TILE_BYTES wide
   and one element wider, rows wider than shared memory, no row (no
   launch), and the transposed use (a CSC's ``dense()`` read as ``.mT``,
   a CSR's ``dense(transpose=True)``, a BSR's element CSR), with the same
   bits wherever a position gets one entry; its indicator template
   (``indicator_check``: bf16 1.0 at each stored entry) on the same
   patterns and index widths, at the tile's edge and over a repeated
   column, the same bits as its plain version.  K13 masked compaction
   (``check_k13``) against its plain version in every value type and
   index width on ``K13_CASES`` (16-byte and scalar loads of P, a P one
   element into its buffer, ``triangular`` with and without a row offset,
   empty and full rows, an exact zero of C kept, no position, rows of
   300,000 columns in work items of 2 steps, no row) and at case a with
   and without ``triangular``, each with P's masks kept in shared memory
   and with none (P read again in the fill): equal indptr and indices,
   the same bits of data, one launch a call, each call twice.  Then
   ``torch.autograd.gradcheck`` (reverse and forward mode) of
   ``ops.coo_spmm_raw``, ``coo_spmv``, ``csr_spmm``, the BSR device
   function ``ops.bsr_spmm`` (on both K1 variants), ``csr_spgemm_dense``
   and ``csr_spgemm`` with tracked operands (each with and without
   ``triangular``) on the card in f64 and c128, and
   ``torch.autograd.gradgradcheck`` (with forward over reverse) of
   ``coo_spmm_raw``, ``coo_spmv``, ``csr_spmm`` and ``csr_spmv``, of
   ``ops.bsr_spmm`` at bs 8 (f64, tensor cores) and bs 3 (c128), of
   ``csr_spgemm_dense`` with and without ``triangular`` and over shuffled
   op(B) with ``b_sorted=False``, and of ``csr_spgemm`` with and without
   ``triangular``, in f64 and c128, with the plain versions refused and
   K1-K9 and K11 (K1 and K8 in both variants) launched;
3. the main path, ``dot_product`` with scipy/numpy operands at real
   sizes, against the scipy oracle at the reference's decimal=6 (f64)
   and decimal=5 (f32), with each kernel's launch count checked (the
   config-3 and dense x BSR calls on K1's tensor-core variant, a complex
   BSR on its complex instances); then, with the counts set to 0 again, the
   sparse x sparse path: the reference demo's X @ X.T (f64, f32, dense
   with ``out``) and its gram, BASELINE config 4's complex gram, a
   1M x 1M A @ A, config 3's BSR x BSR and a 50k-row ``sypr``; in both,
   the plain versions of K1-K9, K11 and K12 are made to raise; then the
   densify route (``densify_path``), each call alone with its exact
   launches: the demo X @ B (n = 128; f64, f32, f64 with
   ``out``/``out_scalar``), config 1's shape at 10% as CSR (also with
   ``out``/``out_scalar``), CSC and dense x CSR, the demo X @ X.T with
   dense output and its dense gram, each on
   K12 where the gates of ``ops/host`` send it, config 1 at 1% (below the
   crossover: K2) and config 1 at 10% with inf, -inf and nan in B (K2 by
   the finite check, scipy's inf and nan); and the structural densify
   route of sparse output (``sparse_path``): the demo X @ X.T and its gram
   on K12, its indicator and K13 (no K4 or K5), their patterns scipy's
   structural product; X with inf and nan (K4 + K5 after the route's host
   read: scipy's values); a repeat call on one container (K13 alone: the
   kept planes); a dense x BSR above the gate (K12, not K1).  In phase
   3's sparse x sparse calls the gate's choice sets the expected launches
   of each product, and cases c, d and e must stay on K4 + K5;
4. kernel and plain-version times at the phase-3 shapes and, for K2 and
   K3, at the solvers' matrices (the 1M Laplacian at n = 1, 4, 16, CGLS's
   A and A^T at n = 1, 4; K3 on the Laplacian, the convection-diffusion
   matrix and CGLS's A and A^T): median, p10 and p90 of 25 launches timed
   with CUDA events, L2 evicted by a 1 GiB read before each.  Each row
   also has ``bound_ms`` (the larger of the bytes the call must move over
   3.35 TB/s and its FLOPs over the peak of the units it runs on, from
   this run's inputs), ``bound_by``, ``share`` (bound_ms / ms) and
   ``library_ms``, the time of the one torch call that computes the same
   function (cuSPARSE through ``torch.sparse.mm``, ``torch.addmm`` or
   ``A_csr @ x``; ``library`` names it, or the error with which torch
   refused it), timed the same way and never called by the port; for K1
   also TFLOP/s and the stored blocks per block row; for K4 (with the
   plan given, and building it in its launch), K5, K4 + K5 as one
   product and K6 also products per second; the product's steps at cases
   a and c (``csr_spgemm``'s marks: device and host ms of each); K6 at
   cases a, a with ``triangular`` (the gram's launch) and d, each beside
   ``yardstick_ms``, the JAX package's algorithm for it (both operands
   densified, one ``torch.matmul``), at case a in f32 and with int64
   indices, at d and at n = 16,384 over shuffled op(B), and at two widths
   past shared memory (n = 100,000 and 40,000) over sorted and shuffled
   op(B); K7 at config 1 (n = 128) and at the 1M^2 matrix (n = 1), beside
   ``torch.sparse.sampled_addmm`` and, in the same turns, K2 (K3) on the
   same pattern, with the gathered bytes (nnz * n * itemsize) and the
   rate each reaches over them; K8 at config 3 (bs 64, n = 256, f64 and
   f32, tensor cores) beside ``torch.bmm`` of the strips gathered
   beforehand and, in the same turns, its CUDA-core variant (the kernel
   that served every value type before), and at the complex BSR (bs 16,
   n = 64) in c128 and c64 on the tensor cores' complex instances beside
   the CUDA-core variant launched directly, then
   the CUDA-core variant's own row (K1 the same at that BSR, beside
   ``torch.sparse.mm``); K9 at cases a and d in both forms
   beside op(B) (op(A)) densified and ``torch.sparse.sampled_addmm`` and,
   for dB, in the same turns, the copy of G^T a backward without the dB
   form makes; K11 at cases a and c in both forms (G random on C's
   pattern; 5 turns where a call takes over 50 ms), beside it in the
   same turns the call as ``CsrSpgemmSparseSddmm`` makes it (patterns
   given, no host read) and at a G and Y densified +
   ``torch.sparse.sampled_addmm`` and K9 on G densified;
   K8's, K9's and K11's rows also carry ``device_ms``, the kernels' own
   time in a ``torch.profiler`` trace of 10 calls; the batched launches
   (``batched_rows``, each beside the same members' single launches in
   the same turns, ``ms_over_single_launches``): K2 at config 1 over 4
   and 16 value sets (b shared: a group of members a block) beside
   ``torch.bmm`` of a batched sparse COO, K2 at n = 1 on the 1M^2 matrix
   over 4 value sets (``CsrSpmv``'s ``vmap`` over the values) beside 4 K3
   launches, both also beside the per-member instance (one member a
   block, as the parent ran them: ``k2_batched_at``) and with
   ``device_ms``, K7 at config 1 over 4
   and 16 (G, B) pairs beside batched-CSR ``torch.sparse.sampled_addmm``,
   K7 at config 1 over 16 G's with B shared and 16 B's with G shared
   (``k7_batched_rows``: through ``CsrSddmm``, beside
   ``sampled_addmm`` given the shared operand expanded into a copy),
   K1 and K8 at config 3 (bs 64, f64) and at the complex BSR over 4
   members, beside their rows' yardsticks made once a member (the complex
   ones also beside the CUDA-core variant's batched launch); K6 at the
   demo X @ X.T over 4 and 16 value sets, K9 there in both forms over 4
   G's, K11 at cases a and c in both forms over 4 G's (patterns given as
   ``CsrSpgemmSparseSddmm`` gives them) and K5 at case c and at case h
   (100,000^2, Poisson(10) a row, A @ A: sorted-product rows) over 4
   value sets on one plan, a group of members a block in each bin,
   beside the per-member instance and 4 x ``torch.sparse.mm(A_csr,
   B_csr)`` (``k5_batched_row``; ``batched_spgemm_rows``, each with
   ``device_ms``, its ratios to the single launches by events and on
   the device, and K9's and K11's group: members, lines a member); and
   the wall time
   of ``dot_product(X, X.T)`` beside scipy's; K12 at config 1's A, the
   demo X and PARDISO's n = 12,000 matrix beside
   ``torch.sparse_csr_tensor(...).to_dense()`` (``4-k12``); the
   crossover sweep (``densify_sweep``, ``4-densify``): K2 against the
   densify route (the finite check, K12, ``torch.matmul``) at 10,000^2,
   n in {16, 128, 512}, densities 0.5-40%, the four value types, and K6
   against it at the demo X's shape (X @ X.T with and without
   ``triangular``, X @ Y.T) at 1, 5, 21.2 and 50%, each point checked
   first, with both times, the route's parts, the gate's choice and
   whether it took the faster route; and K4 + K5 against the structural
   route (``sparse_sweep``) at the demo X's shape (X @ X.T with and
   without ``triangular``, X @ Y.T) at 1, 5, 21.2 and 50% in the four
   value types, A @ A at 10,000^2 at 0.1, 1 and 5% (each type) and case
   d (config 3's BSR x BSR, f64), with the
   route's parts and its time on a container with kept planes; the
   constants ``fit_gate`` fits to all of it and where they would miss;
   K13 at case a, a-tri and config 4's c128 gram X^T X beside
   ``torch.nonzero`` + gather, K12's indicator template beside K12 on ones
   cast to bf16 (``k13_rows``, ``4-k12``).  K12's and K13's rows and the
   sweep run first in phase 4, as ``--only densify`` runs them;
5. the solver path, with the counts set to 0 again and the plain versions
   of K1-K9 and K11 made to raise, each result checked against
   scipy/numpy on the host: the handle protocol on the demo X (create,
   convert from CSC, order a row-shuffled copy, ``matmul_handles(X,
   X.T)`` on the structural densify route or K4 + K5, as the gate says,
   export); CG (K3) on a 1M-row 5-point Laplacian +
   0.01 I, full and as its upper triangle under the symmetric
   descriptor, and its first 20 steps stepwise against the fused loop (same bits); ``cg_mrhs`` (K2)
   with 16 right-hand sides; FGMRES(20) (K3) on a 1M-row upwind
   convection-diffusion matrix; ``sparse_qr_solve`` by Householder QR
   (20000 x 500) and by CGLS (BASELINE config 5's 1.2M x 50k: K3 for
   one right-hand side, K2 for four);
   ``pardiso`` by dense LU (n = 12000 f64, phases 13 then 33 with new
   right-hand sides; c128 n = 4000 with iparm[11] = 2; mtype 2 stored as
   its upper triangle; each densified by K12, as is the Householder QR's
   operand) and by its Krylov route (the 1M SPD system at mtype
   2).  Per solve: wall ms host in to host out (median, min and max of 5
   after a checked first call), iterations, ms per iteration beside one
   K3 (K2) call's time on the same matrix (phase 4's),
   the device's busy ms in a ``torch.profiler`` trace of one more solve
   and its idle share against the median wall, the host syncs counted in
   ``torch.cuda.set_sync_debug_mode("warn")`` and the launches;
6. the training path, with the counts set to 0 again and the plain
   versions of K1-K9 and K11 made to raise: SGD through
   ``ops.coo_spmm_raw`` from zero values toward T = A B on BASELINE
   config 1's pattern and phase 3's B (20 steps in f64 on the values;
   20 in f32 with B trained too), 10 steps of ``ops.coo_spmv`` on the 1M^2 matrix with x trained too, and
   one step through ``torch.func.vmap`` over 4 right-hand sides (one K2
   launch), ``vmap`` of ``grad`` over 3 right-hand sides (K2 once,
   folded; K7 once, batched) and ``vmap`` over 3 value sets (K2 once,
   batched); every loss finite and at or below the one before up to
   rounding, every result with a grad_fn, the gradients at each run's
   first and last step equal to the plain versions' on the same tensors;
   per run the wall ms of a step (median of steps 2..N), and the device's
   busy ms of an f64 step in a ``torch.profiler`` trace.  Then, each with
   the counts set to 0 again: 15 f64 SGD steps through ``ops.bsr_spmm``
   on config 3's blocks and b (K1 forward, K8 and K1 over A^H backward,
   on the tensor cores), 5 on a 4000^2 BSR of 20 x 20 blocks (on the
   CUDA cores) and 5 on a 4000^2 c128 BSR of 16 x 16 blocks (on the
   tensor cores' complex instances), and 10 through
   ``csr_spgemm_dense`` on the demo X's values as op(A) and a copy of
   X^T's CSR as op(B) (K6 forward, K9
   twice backward), plus one step with ``triangular``; 10 through
   ``csr_spgemm`` (sparse output) on case c's 1M^2 A @ A, both operands'
   values on A's one pattern trained toward (A @ A)'s values (K4 + K5
   forward, K11 twice backward, lines in place), and 10 on case a's
   demo X @ X.T (lines staged); losses non-increasing, gradients at the
   first and last step equal to torch's through the plain versions, the
   device's busy ms and idle share of a step.  Hessian-vector products
   by double backward of sum(sin(.)) along a random direction, f64, in
   both differentiable operands, each against torch's double backward
   through the plain versions (within 1e-12 of max|plain|), with its
   wall ms host to host (first call, median of 5 more), the device's
   busy ms and its exact launches: through ``ops.bsr_spmm`` at config 3
   in the blocks and b (K1 6, K8 3), through ``csr_spgemm_dense`` on the
   demo X @ X.T (K6 3, K9 6), through ``csr_spgemm`` on case c's 1M^2
   A @ A (K4 1, K5 3, K11 6), and through ``coo_spmm_raw`` on config 1
   in the values and b (K2 6, K7 3).  Then the batched runs
   (``batched_training``, the ``vmap`` path), each with its exact
   launches, wall ms, the device's busy ms and the same work one member
   at a time in the same turns: per-sample gradients over 16 right-hand
   sides at config 1 (K2 1, folded; K7 1, batched), an ensemble over 4
   value sets of A at config 1, b shared (K2 1, a group of members a
   block; K7 1, B shared; both batched), an ensemble over 4
   block sets at config 3 (K1 1, K8 1, batched), per-sample gradients
   over 4 b's at the complex BSR (c128, bs 16: K1 2, folded; K8 1,
   batched; the tensor cores' complex instances), ``jacrev`` of
   ``coo_spmm_raw`` in the values at a small pattern (K2 1, K7 1) and
   ``hessian`` of sum(sin(.)) in (values, b) there (K2 6, K7 3), against
   the plain versions; then the sparse x sparse ones
   (``batched_spgemm_training``): an ensemble over 4 value sets of the
   demo X through ``csr_spgemm_dense`` with its gradients (K6 1, K9 2,
   all batched), ``jacrev`` of ``csr_spgemm_dense`` at a small pattern
   (K6 1, K9 1 batched), ``hessian`` of sum(sin(``csr_spgemm``)) there
   (K4 1, K5 3 of which 2 batched, K11 6 batched) and an ensemble over 4
   value sets of the 1M^2 A @ A with sparse output and its gradients (K4
   1, K5 1 and K11 2 batched);
7. the sharded layer (``sparse_dot_tpu_torch.parallel``) in a one-rank
   NCCL group on the card (one card: NCCL takes one rank a GPU), the
   plain versions refused: ``sharded_spmm`` at config 1 (f64, f32, c128),
   ``sharded_spmm_2d``, ``sharded_spmm_ring`` and ``dot_product`` on a
   ShardedCSR with ``out``/``out_scalar`` at config 1, ``sharded_spmv``,
   ``sharded_spmv_halo`` (halo 1) and ``sharded_cg`` (atol 1e-10) on the
   1M Laplacian, ``sharded_spgemm`` on the demo X @ X.T and config 1's
   A @ A, ``sharded_gram`` of the demo X, and ``sharded_cgls`` and
   ``sparse_qr_solve`` on a ShardedCSR (one and four right-hand sides)
   at config 5's 1.2M x 50k; each against the single-device port (the
   same kernels, its operand already on the card) and scipy at decimal
   6 (5 for f32), the solvers by their true residuals; per op a line
   with the wall ms host to host (first call apart, median, min and max
   of 5 after it), the single-device port's in the same turns, the
   device's busy ms of one more call and one call's launches, beside
   the card line; the sharded calls' launches are the ``sharded`` path
   (K2, K3 and K6 must move; in a group of one the sums and gathers are
   the identity and NCCL is not called); the host and device ms a call of
   NCCL's collectives that a sharded CG / CGLS step makes across ranks
   (``collective_times``);
   and the group is left at the end.

Then the card line, a JSON line of per-kernel results (its first phase-4
row's times, bound and library time, the launches of each path and the
batched ones among them) and,
last, ``{"ok": true, "device": {...}}``.  Each phase's line carries
``elapsed_s``, the seconds since the script started.  With
``CHIP_SMOKE_LOG`` set to a path, every JSON line also goes to that
file.  Any failure is an uncaught exception
and a non-zero exit; without a CUDA device it exits 2 before any work.
``--only spgemm`` runs the sparse x sparse parts of phases 1-4 and prints
no result lines; ``--only k6`` runs phase 1 and K6's phase-4 rows;
``--only k7`` runs phase 1, K7's phase-2 checks (without gradcheck), its
phase-4 rows and phase 6's config-1 f64 steps, and prints no result line;
``--only k8`` (``k9``, ``k11``) the same for K8 (K9, K11): phase 1, its
phase-2 checks (for K11 with ``csr_spgemm``'s gradcheck and the device
API's gradgradcheck), its phase-4 rows and its phase-6 runs with their
Hessian-vector products (K8: the BSR one; K9: the dense-output one;
K11: the sparse-output and the CSR ones); ``--only sharded`` runs phase 1
and phase 7 and prints no result line; ``--only batched`` runs phase 1,
``check_batched``, ``batched_rows``, ``batched_spgemm_rows`` and
``batched_training``, and prints no result line; ``--only groups`` runs
phase 1, ``check_groups``, batched K1's (config 3), K2's, K5's and
K6's phase-4 rows and ``batched_training``, and prints no result line; ``--only densify`` runs
phase 1, ``check_k12``, ``check_k13``, ``densify_path`` (with
``sparse_path``), ``k12_rows``, ``k13_rows`` and ``densify_sweep``, and
prints no result line; ``--only bsr`` runs phase 1, K1's and K8's
phase-2 checks (``check_k1`` and ``check_bsr_batched`` in every value
type, ``check_k1_special``, K8's part of ``check_k8_k9``), ``k1_rows``,
``k8_rows``, ``bsr_batched_rows``, K8's phase-6 runs and
``complex_bsr_vmap``, and prints no result line.
"""

import argparse
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import scipy.sparse as sps
import torch

SEED = 20261016
REPS = 25
# Timed repeats of each phase-5 solve after its checked first call.
SOLVE_REPS = 5
# Phase-3 sizes: BASELINE config 1 (CSR side), config 3 (BSR side), the
# SpMV rows and the complex SpMM side.
SIZES = {"config1": 10_000, "config3": 8192, "spmv": 1_000_000,
         "complex": 4000, "grid": 1000}
RTOL = {
    torch.float32: 1e-5,
    torch.complex64: 1e-5,
    torch.float64: 1e-12,
    torch.complex128: 1e-12,
    # K12's indicator template writes the same bits as its plain version.
    torch.bfloat16: 0.0,
}
NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}
KERNELS = {
    "K1_bsr_spmm_tc": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "sparse_dot_tpu/ops/pallas_bsr.py:57",
    },
    "K1_bsr_spmm_tc_complex": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "sparse_dot_tpu/ops/pallas_bsr.py:57",
    },
    "K1_bsr_spmm_simt": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm_simt.cu",
        "replaces": "sparse_dot_tpu/ops/pallas_bsr.py:57",
    },
    "K2_csr_spmm": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:648",
    },
    "K3_csr_spmv": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spmv.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:769",
    },
    "K4_csr_spgemm_count": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spgemm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:918",
    },
    "K5_csr_spgemm_fill": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spgemm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:1916",
    },
    "K6_csr_spgemm_dense": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spgemm_dense.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:326",
    },
    "K7_csr_sddmm": {
        "source": "sparse_dot_tpu_torch/csrc/csr_sddmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:178",
    },
    "K8_bsr_sddmm_tc": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_sddmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:799",
    },
    "K8_bsr_sddmm_tc_complex": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_sddmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:799",
    },
    "K8_bsr_sddmm_simt": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_sddmm_simt.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:799",
    },
    "K9_csr_spgemm_sddmm": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spgemm_sddmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:326",
    },
    "K11_csr_spgemm_sparse_sddmm": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spgemm_sparse_sddmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:1916",
    },
    "K12_csr_densify": {
        "source": "sparse_dot_tpu_torch/csrc/csr_densify.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:199",
    },
    "K12_csr_indicator": {
        "source": "sparse_dot_tpu_torch/csrc/csr_densify.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:881",
    },
    "K13_csr_compact": {
        "source": "sparse_dot_tpu_torch/csrc/csr_compact.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:1460",
    },
}


# A path to which every JSON line is also written (the file is started
# anew), for output too long to read from the end of the standard output.
LOG = os.environ.get("CHIP_SMOKE_LOG")
# Each JSON line carries the seconds since the script started
# (``elapsed_s``), so that a phase's share of the run can be read.
START = time.perf_counter()


def emit(phase, **fields):
    line = json.dumps({"phase": phase, **fields,
                       "elapsed_s": time.perf_counter() - START})
    print(line, flush=True)
    if LOG:
        with open(LOG, "a") as f:
            f.write(line + "\n")


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip()


def values(rng, size, dtype, scale=1.0):
    """Random values of a numpy dtype, N(0, scale^2) parts."""
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return (v * scale).astype(dtype)


def cuda(arr):
    return torch.from_numpy(np.ascontiguousarray(arr)).cuda()


def compare(kernel_out, plain_out, dtype):
    """Largest |kernel - plain|; raises past rtol * (|plain| + max|plain|)."""
    torch.cuda.synchronize()
    if not (dtype.is_floating_point or dtype.is_complex):
        if not torch.equal(kernel_out, plain_out):
            raise AssertionError("integer outputs differ")
        return 0.0
    rtol = RTOL[dtype]
    scale = float(plain_out.abs().max()) if plain_out.numel() else 0.0
    torch.testing.assert_close(
        kernel_out, plain_out, rtol=rtol, atol=rtol * scale,
        equal_nan=False,
    )
    if not plain_out.numel():
        return 0.0
    return float((kernel_out - plain_out).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_csr(rng, m, k, mean_row, dtype, index_dtype=np.int32,
               empty_every=0, long_row=0, empty_run=0):
    """CSR arrays with Poisson row lengths (some rows empty, one long row
    and a run of ``empty_run`` empty rows from m // 4 optional) and
    unsorted, possibly repeated column indices."""
    lengths = rng.poisson(mean_row, m) if m else np.zeros(0, np.int64)
    if empty_every:
        lengths[::empty_every] = 0
    if long_row and m:
        lengths[m // 2] = long_row
    if empty_run:
        lengths[m // 4:m // 4 + empty_run] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nnz = int(indptr[-1])
    indices = rng.integers(0, k, nnz).astype(index_dtype)
    data = values(rng, nnz, dtype, 1.0 / np.sqrt(max(mean_row, 1)))
    return indptr, indices, data


def log_uniform(rng, size, dtype):
    """Random signs times magnitudes spread log-uniformly over 1e-3..1e3:
    f32 products that plain TF32 (11 bits) would round by up to ~1e-4 of
    the largest, past the f32 tolerance."""
    mag = 10.0 ** rng.uniform(-3.0, 3.0, size)
    return (mag * rng.choice([-1.0, 1.0], size)).astype(dtype)


def random_bsr(rng, nbrows, nbcols, bs, blocks_per_row, dtype,
               index_dtype=np.int32, empty_every=0, split=False):
    """BSR arrays with Poisson block rows (every empty_every-th empty).
    split=True makes block row 1 at least 3x the chunk length S (the mean
    number of stored blocks per block row, rounded up), so K1's
    tensor-core variant splits it and sums the partial tiles; f32 values
    are log-uniform there (``log_uniform``)."""
    lengths = rng.poisson(blocks_per_row, nbrows)
    if empty_every:
        lengths[::empty_every] = 0
    if split:
        rest = int(lengths.sum() - lengths[1])
        lengths[1] = 1
        while lengths[1] < 3 * -(-(rest + lengths[1]) // nbrows):
            lengths[1] += 1
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nblocks = int(indptr[-1])
    indices = rng.integers(0, nbcols, nblocks).astype(index_dtype)
    if split and np.dtype(dtype) == np.float32:
        data = log_uniform(rng, (nblocks, bs, bs), dtype)
    else:
        scale = 1.0 / np.sqrt(max(bs * blocks_per_row, 1))
        data = values(rng, (nblocks, bs, bs), dtype, scale)
    return indptr, indices, data


def check_kernels(spgemm_only=False):
    """Phase 2; with ``spgemm_only`` K4-K6 and the complex inf case of K2
    and K3 alone."""
    rng = np.random.default_rng(SEED)
    rng7 = np.random.default_rng(SEED + 9)
    results = {name: {"cases": 0, "max_abs_err": 0.0} for name in KERNELS}
    bins_seen = set()

    def record(name, err):
        results[name]["cases"] += 1
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    schedules, k6_seen, k7_schedules, k7_seen = set(), set(), set(), set()
    for tdt, npdt in NP_DTYPES.items():
        for itype in (np.int32, np.int64):
            if not spgemm_only:
                check_csr(rng, tdt, npdt, itype, record, schedules)
                check_k1(rng, tdt, npdt, itype, record)
                check_sddmm(rng7, tdt, npdt, itype, record, k7_schedules,
                            k7_seen)
            check_spgemm(rng, tdt, npdt, itype, record, bins_seen, k6_seen)
    k9_lanes = None
    if not spgemm_only:
        check_k1_special(rng, record)
        check_sddmm_special(rng7, record)
        k89, k9_lanes = check_k8_k9()
        results.update(k89)
        k11, k11_lanes, k11_gradcheck = check_k11_all()
        results.update(k11)
        batched_paths, batched_spgemm = check_batched(record)
        k12_paths = check_k12(record)
        k13_paths = check_k13(record)
    check_csr_special(rng, record)
    check_bins_seen(bins_seen)
    check_k6_seen(k6_seen)
    k6_repeats = check_k6_repeats()
    k6_plans = [dict(zip(K6_PLAN_KEYS, seen)) for seen in sorted(k6_seen)]
    if spgemm_only:
        emit(2, kernels=results, spgemm_bins=sorted(bins_seen),
             k6_plans=k6_plans, k6_repeated_column=k6_repeats)
        return results
    if {vec > 1 for vec, _ in schedules} != {True, False}:
        raise AssertionError(f"K2 ran only {schedules} (vec, lanes)")
    check_k7_schedules(k7_schedules, k7_seen)
    emit(2, kernels=results, spgemm_bins=sorted(bins_seen),
         k2_schedules=sorted(schedules), k6_plans=k6_plans,
         k6_repeated_column=k6_repeats,
         k7_schedules=sorted(k7_schedules), k7_edges=sorted(k7_seen),
         k9_lanes=k9_lanes, k11_lanes=k11_lanes,
         batched_16_byte_paths=batched_paths,
         batched_spgemm_seen=batched_spgemm, k12_paths=k12_paths,
         k13_paths=k13_paths,
         gradcheck_launches=check_gradcheck(),
         k11_gradcheck_launches=k11_gradcheck,
         gradgradcheck_launches=check_second_order())
    return results


def check_k7():
    """Phase 2 for K7 alone (``--only k7``): check_sddmm in every value
    type and index width and check_sddmm_special, with every path and
    edge reached."""
    rng7 = np.random.default_rng(SEED + 9)
    results = {"K7_csr_sddmm": {"cases": 0, "max_abs_err": 0.0}}

    def record(name, err):
        results[name]["cases"] += 1
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    k7_schedules, k7_seen = set(), set()
    for tdt, npdt in NP_DTYPES.items():
        for itype in (np.int32, np.int64):
            check_sddmm(rng7, tdt, npdt, itype, record, k7_schedules, k7_seen)
    check_sddmm_special(rng7, record)
    check_k7_schedules(k7_schedules, k7_seen)
    emit(2, kernels=results, k7_schedules=sorted(k7_schedules),
         k7_edges=sorted(k7_seen))


def check_k7_schedules(seen, edges):
    """K7 ran every path with both index widths: the entry kernel with
    16-byte and scalar loads, the span kernel with both loads and rounds
    of 2 and 4 entries; and phase 2 reached every edge of K7_EDGES."""
    paths = {(True, False, 1), (False, False, 1), (True, True, 2),
             (True, True, 4), (False, True, 2), (False, True, 4)}
    want = {path + (bits,) for path in paths for bits in (32, 64)}
    if not want <= seen:
        raise AssertionError(f"K7 never ran {sorted(want - seen)} (16-byte "
                             "loads, span kernel, round, index bits)")
    if set(K7_EDGES) - edges:
        raise AssertionError(f"K7 edges not reached: "
                             f"{sorted(set(K7_EDGES) - edges)}")


# K2 / K3 cases: (m, k, mean row, every k-th row empty, one long row).
# The long row is at least 3x K2's chunk S and 3x K3's tile, so both split
# it; mean rows of 3 and 40 take few and many lanes per row; then nnz == 0
# and an empty matrix.
CSR_CASES = ((300, 200, 3, 5, 0), (257, 190, 12, 0, 3500),
             (128, 300, 40, 3, 0), (50, 40, 0, 0, 0), (0, 40, 2, 0, 0))
CSR_NS = (1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 200)


def misaligned(b, shift):
    """A copy of b (k, n) as a view ``shift`` elements into a larger
    buffer: one row in keeps 16-byte rows aligned, one element in does
    not (except for c128)."""
    k, n = b.shape
    buf = torch.zeros(k * n + shift, dtype=b.dtype, device=b.device)
    view = buf[shift:].view(k, n)
    view.copy_(b)
    return view


def check_csr(rng, tdt, npdt, itype, record, schedules):
    """K2 and K3 against their plain versions at every case of CSR_CASES,
    K2 at every n of CSR_NS, with and without the epilogue; K2 on B views
    misaligned by a row and by an element; the case with a long row run
    twice for the same bits; each row plan built with no host sync.
    ``schedules`` collects K2's (vec, lanes)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import csr

    for m, k, mean_row, empty_every, long_row in CSR_CASES:
        indptr, indices, data = random_csr(
            rng, m, k, mean_row, npdt, itype, empty_every, long_row)
        ip, ix, dv = cuda(indptr), cuda(indices), cuda(data)
        nnz = len(indices)
        with no_host_sync():  # building a row plan never waits
            formats.csr_plan(ip, nnz)
            formats.csr_plan(ip, nnz, spmv=True)
        if long_row and long_row < 3 * max(formats.SPMV_TILE,
                                           formats.spmm_chunk_length(m, nnz)):
            raise AssertionError("K2/K3 case: the long row is too short")
        for n in CSR_NS:
            b = cuda(values(rng, (k, n), npdt))
            c0 = cuda(values(rng, (m, n), npdt))
            views = [b]
            if long_row and n in (4, 16, 64):
                views += [misaligned(b, n), misaligned(b, 1)]
            for bb in views:
                aligned = bb.data_ptr() % 16 == 0
                schedules.add(tuple(csr.spmm_schedule(
                    n, tdt, nnz / max(m, 1), aligned)[:2]))
                for alpha, beta, cc in ((None, None, None),
                                        (0.5, 2.0, c0)):
                    args = (ip, ix, dv, bb, alpha, beta, cc)
                    out = csr.csr_spmm(*args)
                    record("K2_csr_spmm",
                           compare(out, csr.csr_spmm_plain(*args), tdt))
                    if long_row and n in (1, 17, 64) and cc is not None:
                        if not torch.equal(out, csr.csr_spmm(*args)):
                            raise AssertionError(f"K2 n={n}: runs differ")
        x = cuda(values(rng, k, npdt))
        y0 = cuda(values(rng, m, npdt))
        for alpha, beta, yy in ((None, None, None), (-1.5, 3.0, y0)):
            args = (ip, ix, dv, x, alpha, beta, yy)
            out = csr.csr_spmv(*args)
            record("K3_csr_spmv", compare(out, csr.csr_spmv_plain(*args), tdt))
            if long_row and not torch.equal(out, csr.csr_spmv(*args)):
                raise AssertionError("K3: runs differ")


# K1 cases: (bs, nbrows, nbcols, blocks per row, every k-th block row
# empty, one block row split).  bs % 8 == 0 runs the tensor-core variant
# for real values, the rest (and complex values) the CUDA-core one.
K1_CASES = (
    (1, 40, 30, 4, 3, False),
    (3, 30, 20, 3, 4, False),
    (8, 24, 20, 3, 5, True),
    (16, 16, 12, 2, 4, True),
    (24, 12, 10, 2, 3, True),
    (64, 8, 6, 1, 3, True),
    (128, 6, 5, 1, 3, True),
    (256, 6, 4, 1, 3, True),
    (8, 5, 5, 0, 0, False),  # no stored block
)
K1_NS = (1, 37, 64, 256)


def variant_name(kernel, dtype, bs):
    """The KERNELS entry of the K1 (``kernel`` "K1_bsr_spmm") or K8
    ("K8_bsr_sddmm") variant that serves ``dtype`` in bs x bs blocks: the
    tensor cores (their complex instances apart) or the CUDA cores."""
    from sparse_dot_tpu_torch.ops import bsr

    if not bsr.uses_tensor_cores(dtype, bs):
        return f"{kernel}_simt"
    return f"{kernel}_tc_complex" if dtype.is_complex else f"{kernel}_tc"


def variant_counts(wrapper):
    """(tensor cores on real values, on complex values, CUDA cores): the
    launches of ``bsr.bsr_spmm`` or ``bsr.bsr_sddmm`` by variant."""
    return (wrapper.launches_tc - wrapper.launches_tc_complex,
            wrapper.launches_tc_complex, wrapper.launches_simt)


def variant_delta(dtype, bs, count=1):
    """``variant_counts``' change when ``count`` launches take the variant
    that serves ``dtype`` and bs."""
    name = variant_name("K", dtype, bs)
    return tuple(count * (name == f"K_{v}")
                 for v in ("tc", "tc_complex", "simt"))


def k1_call(*args):
    """(variant, bsr_spmm(*args)): the K1 variant that the value type and
    block size select, checked to be the one the launch counts show."""
    from sparse_dot_tpu_torch.ops import bsr

    data = args[2]
    before = variant_counts(bsr.bsr_spmm)
    out = bsr.bsr_spmm(*args)
    variant = variant_name("K1_bsr_spmm", data.dtype, data.shape[1])
    got = tuple(a - b for a, b in zip(variant_counts(bsr.bsr_spmm), before))
    if got != variant_delta(data.dtype, data.shape[1]):
        raise AssertionError(f"bsr_spmm did not launch {variant} once")
    return variant, out


def check_k1(rng, tdt, npdt, itype, record):
    """K1 against bsr_spmm_plain at every case of K1_CASES and n of K1_NS,
    with and without the alpha/beta/C0 epilogue; a split case is run
    twice and must give the same bits."""
    from sparse_dot_tpu_torch.formats import bsr_chunk_length
    from sparse_dot_tpu_torch.ops import bsr

    for bs, nbrows, nbcols, per_row, empty_every, split in K1_CASES:
        indptr, indices, data = random_bsr(
            rng, nbrows, nbcols, bs, per_row, npdt, itype, empty_every,
            split)
        ip, ix, dv = cuda(indptr), cuda(indices), cuda(data)
        lengths = np.diff(indptr)
        if split and (lengths.max() < 3 * bsr_chunk_length(nbrows,
                                                           len(indices))
                      or lengths.min() > 0):
            raise AssertionError(f"K1 case bs={bs}: no split or empty row")
        log_b = split and npdt == np.float32
        for n in K1_NS:
            b = cuda((log_uniform if log_b else values)(
                rng, (nbcols * bs, n), npdt))
            c0 = cuda(values(rng, (nbrows * bs, n), npdt))
            for alpha, beta, cc in ((None, None, None), (2.0, -1.0, c0)):
                args = (ip, ix, dv, b, alpha, beta, cc)
                variant, out = k1_call(*args)
                record(variant, compare(out, bsr.bsr_spmm_plain(*args), tdt))
                if split and n == 37:
                    if not torch.equal(out, k1_call(*args)[1]):
                        raise AssertionError(f"K1 bs={bs}: runs differ")


def check_k1_special(rng, record):
    """inf in A and in B on the tensor-core variant, real (bs 64) and
    complex (bs 16 and 64, with -inf in an imaginary part of each and
    alpha/beta/C0): the same nan, +inf and -inf parts as the plain
    version (3xTF32 must not make inf * 0; complex products follow the
    component formula), finite values within tolerance."""
    from sparse_dot_tpu_torch.ops import bsr

    cases = [(torch.float32, 64), (torch.float64, 64)] + [
        (tdt, bs) for tdt in (torch.complex64, torch.complex128)
        for bs in (16, 64)]
    for tdt, bs in cases:
        npdt = NP_DTYPES[tdt]
        indptr, indices, data = random_bsr(rng, 8, 6, bs, 1, npdt,
                                           split=True)
        data[0, 5, 7] = np.inf
        b = values(rng, (6 * bs, 64), npdt)
        b[100 % (6 * bs), 3] = -np.inf
        extra = ()
        if tdt.is_complex:
            data[-1, 2, 3] = complex(0.0, -np.inf)
            b[indices[-1] * bs + 3, 9] = complex(1.0, -np.inf)
            extra = (0.5 - 1.5j, 2.0, cuda(values(rng, (8 * bs, 64), npdt)))
        args = (cuda(indptr), cuda(indices), cuda(data), cuda(b), *extra)
        variant, out = k1_call(*args)
        ref = bsr.bsr_spmm_plain(*args)
        fin = same_parts(f"K1 {tdt} bs={bs}", out, ref)
        record(variant, compare(out[fin], ref[fin], tdt))


def same_nonfinite(name, out, ref):
    """``out`` (a tensor on the card) against scipy's ``ref``: the same
    nan, +inf and -inf in every real and imaginary part; returns the mask
    of the finite entries."""
    got = torch.view_as_real(out).cpu().numpy()
    want = ref.view(ref.real.dtype).reshape(got.shape)
    for what in (np.isnan, np.isposinf, np.isneginf):
        if not np.array_equal(what(got), what(want)):
            raise AssertionError(f"{name}: {what.__name__} differs from "
                                 f"scipy")
    if not np.isinf(want).any():
        raise AssertionError(f"{name}: no inf reached the output")
    return np.isfinite(ref)


def check_csr_special(rng, record):
    """Complex K2 and K3 with inf in B (x) and in A, against scipy: the
    same inf/nan parts (a product (2+0j)(inf+0j) is inf+nanj, and stays so
    through the sum and the alpha = 1 epilogue), finite values within
    tolerance.  First ROADMAP's 2 x 2 input, then a random matrix."""
    from sparse_dot_tpu_torch.ops import csr

    for tdt in (torch.complex64, torch.complex128):
        npdt = NP_DTYPES[tdt]
        small = (np.array([0, 1, 2]), np.array([0, 1]),
                 np.array([2, 1], dtype=npdt))
        b_small = np.array([[np.inf, 1], [1, 1]], dtype=npdt)
        indptr, indices, data = random_csr(rng, 64, 48, 4, npdt)
        data[7] = np.inf
        b = values(rng, (48, 24), npdt)
        b[5, 3] = np.inf
        b[20, 7] = complex(0.0, -np.inf)
        for (ip, ix, dv), bb in ((small, b_small), ((indptr, indices, data),
                                                    b)):
            a = sps.csr_matrix((dv, ix, ip), shape=(len(ip) - 1, bb.shape[0]))
            args = (cuda(ip.astype(np.int32)), cuda(ix.astype(np.int32)),
                    cuda(dv))
            for name, out, ref in (
                    ("K2_csr_spmm", csr.csr_spmm(*args, cuda(bb)), a @ bb),
                    ("K3_csr_spmv", csr.csr_spmv(*args, cuda(bb[:, 0])),
                     a @ bb[:, 0])):
                fin = same_nonfinite(f"{name} {tdt} inf", out, ref)
                record(name, compare(out[cuda(fin)], cuda(ref[fin]), tdt))


# K7 cases: (m, k, mean row, every k-th row empty, one long row, a run of
# empty rows): empty rows, a row of 100,000 entries (spans inside one row,
# rows longer than a span), nnz == 0, an empty matrix, 3000 rows of 0.05
# entries on average (spans across runs of empty rows) and 9000 rows with
# 6000 empty ones in a run.  SDDMM_NS puts n on both kernels, both load
# widths, rounds of 2 and 4 entries, and strips that end mid-row (130, 200
# and 300 past a strip of 128 or 64 columns).
SDDMM_CASES = ((300, 200, 3, 5, 0, 0), (64, 190, 12, 4, 100_000, 0),
               (50, 40, 0, 0, 0, 0), (0, 40, 2, 0, 0, 0),
               (3000, 300, 0.05, 0, 0, 0), (9000, 250, 2, 0, 0, 6000))
SDDMM_NS = (1, 2, 3, 4, 8, 17, 32, 64, 128, 130, 200, 300)
# The edges of K7's work split that phase 2 must reach (``k7_edges``).
K7_EDGES = ("nnz_not_a_multiple_of_a_round", "nnz_not_a_multiple_of_a_span",
            "span_across_1000_empty_rows", "row_longer_than_a_span",
            "strip_ends_mid_row", "misaligned_takes_scalar_loads")


def k7_edges(indptr, n, s, aligned_vec):
    """Which of K7_EDGES a launch with schedule ``s`` reaches over the CSR
    ``indptr`` at width n; ``aligned_vec`` is the load width the same n
    would take on aligned G and B."""
    nnz, edges = int(indptr[-1]), set()
    if not nnz:
        return edges
    if s.vec == 1 and aligned_vec > 1:
        edges.add("misaligned_takes_scalar_loads")
    if s.lanes == 1:
        return edges
    if nnz % s.round:
        edges.add("nnz_not_a_multiple_of_a_round")
    if nnz > s.span and nnz % s.span:
        edges.add("nnz_not_a_multiple_of_a_span")
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    gap = np.flatnonzero(np.diff(rows) > 1000)  # entries j, j + 1
    if np.any(gap // s.span == (gap + 1) // s.span):
        edges.add("span_across_1000_empty_rows")
    if np.diff(indptr).max() > s.span:
        edges.add("row_longer_than_a_span")
    strip = s.lanes * s.per_lane * s.vec
    if n > strip and n % strip:
        edges.add("strip_ends_mid_row")
    return edges


def check_sddmm(rng, tdt, npdt, itype, record, schedules, edges):
    """K7 against ``csr_sddmm_plain`` at every case of SDDMM_CASES and n of
    SDDMM_NS, with and without alpha; G and B as views one row and one
    element into a buffer (the second misaligned: scalar loads) at n = 4,
    64 and 300; every call without alpha run twice for the same bits.
    ``schedules`` collects K7's (16-byte loads, span kernel, round, index
    bits), ``edges`` the K7_EDGES reached."""
    from sparse_dot_tpu_torch.ops import sddmm

    alpha = 0.5 - 0.25j if np.dtype(npdt).kind == "c" else -1.5
    bits = 8 * np.dtype(itype).itemsize
    for m, k, mean_row, empty_every, long_row, empty_run in SDDMM_CASES:
        indptr, indices, _ = random_csr(
            rng, m, k, mean_row, npdt, itype, empty_every, long_row,
            empty_run)
        ip, ix = cuda(indptr), cuda(indices)
        for n in SDDMM_NS:
            g = cuda(values(rng, (m, n), npdt))
            b = cuda(values(rng, (k, n), npdt))
            views = [(g, b)]
            if n in (4, 64, 300) and m:
                views += [(misaligned(g, n), misaligned(b, n)),
                          (misaligned(g, 1), misaligned(b, 1))]
            aligned_vec = sddmm.sddmm_schedule(n, tdt, len(indices)).vec
            for gg, bb in views:
                aligned = gg.data_ptr() % 16 == 0 and bb.data_ptr() % 16 == 0
                s = sddmm.sddmm_schedule(n, tdt, len(indices), aligned)
                schedules.add((s.vec > 1, s.lanes > 1, s.round, bits))
                edges.update(k7_edges(indptr, n, s, aligned_vec))
                for al in (None, alpha):
                    out = sddmm.csr_sddmm(ip, ix, gg, bb, al)
                    record("K7_csr_sddmm", compare(
                        out, sddmm.csr_sddmm_plain(ip, ix, gg, bb, al), tdt))
                    if al is None and not torch.equal(
                            out, sddmm.csr_sddmm(ip, ix, gg, bb)):
                        raise AssertionError(f"K7 {tdt} n={n} m={m}: runs "
                                             "differ")


def check_sddmm_special(rng, record):
    """K7 with inf in G and in B (+inf, -inf and an imaginary inf): the
    same nan, +inf and -inf parts as the plain version, finite entries
    within tolerance; in every value type, at n = 1 (a thread an entry)
    and n = 24 (groups of lanes)."""
    from sparse_dot_tpu_torch.ops import sddmm

    for tdt, npdt in NP_DTYPES.items():
        indptr, indices, _ = random_csr(rng, 64, 48, 4, npdt)
        for n in (1, 24):
            g = values(rng, (64, n), npdt)
            b = values(rng, (48, n), npdt)
            g[7, 0] = np.inf
            b[indices[3], n - 1] = -np.inf
            if np.dtype(npdt).kind == "c":
                b[indices[20], 0] = complex(0.0, -np.inf)
            args = (cuda(indptr), cuda(indices), cuda(g), cuda(b))
            out, ref = sddmm.csr_sddmm(*args), sddmm.csr_sddmm_plain(*args)
            fin = same_parts(f"K7 {tdt} n={n}", out, ref)
            record("K7_csr_sddmm", compare(out[fin], ref[fin], tdt))


# K8 cases: (bs, block rows, block columns, stored blocks a row, every
# k-th block row empty): empty block rows in each, then no stored block.
# K8_NS puts n at one column, a ragged stage of 16 (37) and whole stages.
K8_BS = (1, 3, 8, 16, 24, 64, 128)
K8_NS = (1, 37, 64, 256)


def k8_call(*args):
    """bsr_sddmm(*args), checked to launch K8 once (none with no block),
    on the variant ``uses_tensor_cores`` names: the tensor cores for bs %
    8 == 0 (complex values on their own instances), else the CUDA
    cores."""
    from sparse_dot_tpu_torch.ops import bsr

    wrapper = bsr.bsr_sddmm
    before = (wrapper.launches, *variant_counts(wrapper))
    out = wrapper(*args)
    once = int(args[1].numel() > 0)
    want = (before[0] + once, *(a + b for a, b in zip(
        before[1:], variant_delta(args[2].dtype, args[4], once))))
    if (wrapper.launches, *variant_counts(wrapper)) != want:
        raise AssertionError(f"bsr_sddmm did not launch "
                             f"{k8_name(args[2].dtype, args[4])} once")
    return out


def k8_name(dtype, bs):
    """The KERNELS entry of the K8 variant that serves ``dtype`` and bs."""
    return variant_name("K8_bsr_sddmm", dtype, bs)


def check_k8(rng, tdt, npdt, itype, record):
    """K8 against ``bsr_sddmm_plain`` at every bs of K8_BS and n of K8_NS,
    with and without alpha, on G and B and on views of them one row into a
    buffer, block rows empty every third and a BSR with no stored block;
    every call run twice for the same bits."""
    from sparse_dot_tpu_torch.ops import bsr

    alpha = 0.5 - 0.25j if np.dtype(npdt).kind == "c" else -1.5
    for bs in K8_BS:
        nbrows, nbcols = (3, 4) if bs >= 64 else (7, 5)
        cases = [random_bsr(rng, nbrows, nbcols, bs, 2, npdt, itype, 3)[:2],
                 (np.zeros(nbrows + 1, itype), np.zeros(0, itype))]
        for indptr, indices in cases:
            ip, ix = cuda(indptr), cuda(indices)
            for n in K8_NS:
                g = cuda(values(rng, (nbrows * bs, n), npdt))
                b = cuda(values(rng, (nbcols * bs, n), npdt))
                for gg, bb in ((g, b), (misaligned(g, n), misaligned(b, n))):
                    for al in (None, alpha):
                        args = (ip, ix, gg, bb, bs, al)
                        out = k8_call(*args)
                        ref = bsr.bsr_sddmm_plain(*args)
                        record(k8_name(tdt, bs), compare(out, ref, tdt))
                        if not torch.equal(out, k8_call(*args)):
                            raise AssertionError(f"K8 {tdt} bs={bs} n={n}: "
                                                 "runs differ")


def same_parts(name, out, ref):
    """``out`` and ``ref`` (tensors on the card) hold the same nan, +inf
    and -inf in every real and imaginary part, and some inf; returns the
    mask of the entries finite in ``ref``."""
    torch.cuda.synchronize()
    got, want = (torch.view_as_real(t) if t.is_complex() else t
                 for t in (out, ref))
    for what in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(what(got), what(want)):
            raise AssertionError(f"{name}: {what.__name__} differs from the "
                                 "plain version")
    if not bool(torch.isinf(want).any()):
        raise AssertionError(f"{name}: no inf reached the output")
    return torch.isfinite(ref) if not ref.is_complex() else (
        torch.isfinite(ref.real) & torch.isfinite(ref.imag))


def check_k8_special(rng, record):
    """K8 with inf in G and in B (+inf, -inf, and an imaginary inf for
    complex values) in every value type, at bs = 3, 8 and 64 (the
    CUDA-core variant, then the tensor cores' 16- and 64-row tiles; for
    complex values 32-row tiles at 64): the same nan, +inf and -inf parts
    as the plain version, finite entries within tolerance."""
    from sparse_dot_tpu_torch.ops import bsr

    for tdt, npdt in NP_DTYPES.items():
        for bs in (3, 8, 64):
            indptr, indices, _ = random_bsr(rng, 4, 3, bs, 2, npdt)
            g = values(rng, (4 * bs, 40), npdt)
            b = values(rng, (3 * bs, 40), npdt)
            g[1, 0] = np.inf
            b[indices[0] * bs + 2, 39] = -np.inf
            if np.dtype(npdt).kind == "c":
                b[indices[-1] * bs, 5] = complex(0.0, -np.inf)
            args = (cuda(indptr), cuda(indices), cuda(g), cuda(b), bs)
            out, ref = k8_call(*args), bsr.bsr_sddmm_plain(*args)
            fin = same_parts(f"K8 {tdt} bs={bs}", out, ref)
            record(k8_name(tdt, bs), compare(out[fin], ref[fin], tdt))


# K9 cases: (rows of P, columns of P, mean row of P, every k-th row of P
# empty, Y's column range (the length of D's lines), mean row of Y,
# every k-th row of Y empty, one row of Y this long): Y's mean rows put
# K9 on groups of 1, 2, 4, 8, 16 and 32 lanes
# (``spgemm_grad.sampled_lanes``), the fifth has a row of Y of 2000
# entries (longer than a group holds), the sixth 6000 short rows of P,
# the last no entry in P.  Each case runs in both forms: the dA form (D's
# rows, P's columns name Y's rows) and the dB form (D's columns, P's
# rows name Y's rows), with D's lines staged in shared memory (panels of
# 4 to 32 lines) and, with K9_BUDGETS' 0, read in place through L1.
K9_CASES = ((300, 200, 3, 5, 150, 1.2, 4, 0), (300, 200, 3, 5, 150, 5, 4, 0),
            (120, 90, 5, 7, 300, 10, 3, 0), (120, 90, 5, 0, 300, 20, 3, 0),
            (64, 190, 6, 3, 3000, 30, 5, 2000),
            (120, 90, 5, 0, 300, 40, 3, 0),
            (6000, 400, 2, 0, 48, 3, 0, 0), (50, 40, 0, 0, 60, 3, 0, 0))
# Shared-memory budgets of K9's panels (``spgemm_grad.SAMPLED_SMEM``): the
# default and none.
K9_BUDGETS = (None, 0)


def k9_call(*args):
    """csr_spgemm_sddmm(*args), checked to launch K9 once (none with no
    entry)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    wrapper = spgemm_grad.csr_spgemm_sddmm
    before = wrapper.launches
    out = wrapper(*args)
    if wrapper.launches != before + int(args[1].numel() > 0):
        raise AssertionError("csr_spgemm_sddmm did not launch K9 once")
    return out


def k9_operands(rng, case, npdt, itype, transposed):
    """(P's indptr and indices, D, Y's arrays) of a K9_CASES case on the
    card: Y has as many rows as P has columns (the dA form) or rows (the
    dB form) and w columns; D is (rows of P, w) in the dA form and (w,
    columns of P) in the dB form."""
    mp, kp, mean_p, empty_p, w, mean_y, empty_y, long_y = case
    p_ip, p_ix, _ = random_csr(rng, mp, kp, mean_p, npdt, itype, empty_p)
    y_rows, d_shape = (mp, (w, kp)) if transposed else (kp, (mp, w))
    y = random_csr(rng, y_rows, w, mean_y, npdt, itype, empty_y, long_y)
    d = values(rng, d_shape, npdt)
    return (cuda(p_ip), cuda(p_ix)), cuda(d), tuple(map(cuda, y))


@contextlib.contextmanager
def k9_budget(budget):
    """Inside the block, K9's panels get ``budget`` bytes of shared
    memory (``spgemm_grad.SAMPLED_SMEM``; None keeps the default)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    saved = spgemm_grad.SAMPLED_SMEM
    if budget is not None:
        spgemm_grad.SAMPLED_SMEM = budget
    try:
        yield
    finally:
        spgemm_grad.SAMPLED_SMEM = saved


def k9_plan(d, y_ip, y_ix, transposed):
    """The ``SampledPlan`` K9 takes for these operands."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    return spgemm_grad.sampled_plan(
        d.shape[0] if transposed else d.shape[1], d.element_size(),
        y_ix.numel() / max(y_ip.numel() - 1, 1), transposed)


def check_k9(rng, tdt, npdt, itype, record, lanes_seen, plans_seen):
    """K9 against ``csr_spgemm_sddmm_plain`` at every case of K9_CASES in
    both forms, under each budget of K9_BUDGETS, with and without alpha;
    every call run twice for the same bits.  ``lanes_seen`` collects the
    groups' widths, ``plans_seen`` (form, staged) of each
    launch."""
    alpha = 0.5 - 0.25j if np.dtype(npdt).kind == "c" else -1.5
    from sparse_dot_tpu_torch.ops import spgemm_grad

    for case in K9_CASES:
        for transposed in (False, True):
            (ip, ix), d, (y_ip, y_ix, y_dv) = k9_operands(
                rng, case, npdt, itype, transposed)
            for budget in K9_BUDGETS:
                with k9_budget(budget):
                    plan = k9_plan(d, y_ip, y_ix, transposed)
                    if ix.numel():
                        lanes_seen.add(plan.lanes)
                        plans_seen.add(("dB" if transposed else "dA",
                                        plan.staged))
                    for al in (None, alpha):
                        args = (ip, ix, d, y_ip, y_ix, y_dv, al, transposed)
                        out = k9_call(*args)
                        record("K9_csr_spgemm_sddmm", compare(
                            out, spgemm_grad.csr_spgemm_sddmm_plain(*args),
                            tdt))
                        if not torch.equal(out, k9_call(*args)):
                            raise AssertionError(f"K9 {tdt} {case}: runs "
                                                 "differ")


def check_k9_special(rng, record):
    """K9 with inf in D and in Y (+inf, -inf, and an imaginary inf for
    complex values), both forms, in every value type: the same nan, +inf
    and -inf parts as the plain version, finite entries within
    tolerance."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    for tdt, npdt in NP_DTYPES.items():
        for transposed in (False, True):
            (ip, ix), d, (y_ip, y_ix, y_dv) = k9_operands(
                rng, (60, 50, 4, 0, 40, 6, 0, 0), npdt, np.int32, transposed)
            d[3, :5] = np.inf
            d[:4, 7] = -np.inf
            y_dv[5] = -np.inf
            if np.dtype(npdt).kind == "c":
                y_dv[9] = complex(0.0, np.inf)
            args = (ip, ix, d, y_ip, y_ix, y_dv, None, transposed)
            out = k9_call(*args)
            ref = spgemm_grad.csr_spgemm_sddmm_plain(*args)
            fin = same_parts(f"K9 {tdt} transposed={transposed}", out, ref)
            record("K9_csr_spgemm_sddmm", compare(out[fin], ref[fin], tdt))


def check_k8_k9(which=("K8", "K9")):
    """Phase 2 for K8 and K9 (``--only k8``, ``--only k9``, and inside
    ``check_kernels``' run): every value type and index width, the inf
    cases, K8 on both variants (``k8_call`` checks which one each call
    launched), and K9 in both forms on every width of group, on panels of
    4 to 32 lines in shared memory and on lines read in place."""
    rng = np.random.default_rng(SEED + 11)
    results = {name: {"cases": 0, "max_abs_err": 0.0} for name in KERNELS
               if name.split("_")[0] in which}

    def record(name, err):
        results[name]["cases"] += 1
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    lanes_seen, plans_seen = set(), set()
    for tdt, npdt in NP_DTYPES.items():
        for itype in (np.int32, np.int64):
            if "K8" in which:
                check_k8(rng, tdt, npdt, itype, record)
            if "K9" in which:
                check_k9(rng, tdt, npdt, itype, record, lanes_seen,
                         plans_seen)
    if "K8" in which:
        check_k8_special(rng, record)
    if "K9" in which:
        check_k9_special(rng, record)
        if lanes_seen != {1, 2, 4, 8, 16, 32}:
            raise AssertionError(f"K9 ran groups of {sorted(lanes_seen)} "
                                 "lanes only")
        want = {(form, staged) for form in ("dA", "dB")
                for staged in (True, False)}
        if plans_seen != want:
            raise AssertionError(f"K9 ran the plans {sorted(plans_seen)}, "
                                 f"not {sorted(want)}")
    return results, sorted(lanes_seen)


# K11 cases: (m rows of op(A), k, n, op(A)'s rows in turn, op(B)'s rows
# in turn); each list of lengths repeats over the rows, an entry 0 an empty
# row.  Their mean rows of Y (op(B) in the dA form, op(A)^T in the dB
# form) give groups of every width, 1 to 32 lanes, staged and in place.
# The fourth gives C a row of over 2000 entries (op(A)'s row 10 names
# every row of op(B)): staged in the dA form where 4 of its lines of 3000
# fit (f32, f64, c64; c128 under the budget of 220 KB), searched in place
# where not; the third's m = 6000 is too long to stage in the dB form but
# under the budget of 220 KB; the last two have no entry of op(A) (the dA
# form launches nothing, the dB form sums nothing) and none of op(B).
K11_CASES = ((60, 50, 40, (4, 5, 3, 0), (5, 6, 0, 4)),
             (200, 60, 100, (10, 12, 0, 8), (20, 22, 18)),
             (6000, 400, 300, (2, 0, 3, 2), (1, 2, 0, 3)),
             (20, 30, 3000, (2,) * 10 + (30,) + (2,) * 9, (150,)),
             (64, 64, 64, (6, 0, 7, 5), (12, 10, 14, 0)),
             (50, 40, 30, (0,), (3, 4)),
             (50, 40, 30, (3, 4), (0,)))
# Shared-memory budgets of K11's staged lines (``spgemm_grad.SPARSE_SMEM``;
# None keeps the default of 112 KB): the default, none (every line read
# in place) and 220 KB.
K11_BUDGETS = (None, 0, 220 * 1024)
# What each launch reads (form, staged or not, a row of C past 2000
# entries): phase 2 must reach every one.
K11_MODES = {(form, staged, long) for form in ("dA", "dB")
             for staged in (True, False) for long in (False, True)}


def k11_call(*args):
    """csr_spgemm_sparse_sddmm(*args), checked to launch K11 once (none
    where P, op(A) in the dA form and op(B) in the dB form, has no
    entry)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    wrapper = spgemm_grad.csr_spgemm_sparse_sddmm
    p_indices = args[4] if args[10] else args[1]
    before = wrapper.launches
    out = wrapper(*args)
    if wrapper.launches != before + int(p_indices.numel() > 0):
        raise AssertionError("csr_spgemm_sparse_sddmm did not launch K11 "
                             "once")
    return out


def k11_operands(rng, case, npdt, itype, triangular):
    """(op(A)'s arrays, op(B)'s arrays, C's indptr and indices, G, n) of a
    K11_CASES case on the card: rows of distinct shuffled columns, C by
    ``csr_spgemm`` (K4 + K5), G random on C's pattern."""
    from sparse_dot_tpu_torch.ops import spgemm

    m, k, n, a_rows, b_rows = case
    a = distinct_rows(rng, np.resize(a_rows, m), k, npdt, itype)
    b = distinct_rows(rng, np.resize(b_rows, k), n, npdt, itype)
    a, b = tuple(map(cuda, a)), tuple(map(cuda, b))
    c_ip, c_ix, _ = spgemm.csr_spgemm(*a, *b, n, triangular)
    g = cuda(values(rng, c_ix.numel(), npdt))
    return a, b, (c_ip, c_ix), g, n


@contextlib.contextmanager
def k11_budget(budget):
    """Inside the block, K11 stages lines of G in ``budget`` bytes of
    shared memory (``spgemm_grad.SPARSE_SMEM``; None keeps the
    default)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    saved = spgemm_grad.SPARSE_SMEM
    if budget is not None:
        spgemm_grad.SPARSE_SMEM = budget
    try:
        yield
    finally:
        spgemm_grad.SPARSE_SMEM = saved


def k11_plan(a, b, g, n, transposed):
    """The plan (``SampledPlan``) K11 takes for these operands."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    k = b[0].numel() - 1
    y_nnz = (a if transposed else b)[1].numel()
    line = a[0].numel() - 1 if transposed else n
    return spgemm_grad.sparse_plan(line, g.element_size(), y_nnz / max(k, 1))


def same_bits(x, y):
    """x and y hold the same bits (nan included)."""
    def bits(t):
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.view(torch.int32 if t.element_size() == 4 else torch.int64)
    return torch.equal(bits(x), bits(y))


def check_k11(rng, tdt, npdt, itype, record, lanes_seen, rows_seen):
    """K11 against ``csr_spgemm_sparse_sddmm_plain`` at every case of
    K11_CASES in both forms, with and without ``triangular``, under each
    budget of K11_BUDGETS; every call run twice for the same bits.
    ``lanes_seen`` collects (staged, lanes) of each launch, ``rows_seen``
    the K11_MODES it reads (the dA form reads the rows of C of op(A)'s
    non-empty rows, the dB form any)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    for case in K11_CASES:
        for triangular in (False, True):
            a, b, (c_ip, c_ix), g, n = k11_operands(rng, case, npdt, itype,
                                                    triangular)
            lengths = c_ip.diff().cpu().numpy()
            a_rows = np.diff(a[0].cpu().numpy()) > 0
            for transposed in (False, True):
                p = b if transposed else a
                form = "dB" if transposed else "dA"
                for budget in K11_BUDGETS:
                    with k11_budget(budget):
                        plan = k11_plan(a, b, g, n, transposed)
                        args = (*a, *b, c_ip, c_ix, g, n, transposed,
                                triangular)
                        out = k11_call(*args)
                        again = k11_call(*args)
                    if p[1].numel():
                        lanes_seen.add((plan.staged, plan.lanes))
                        rows_seen.update(
                            (form, plan.staged, bool(x > 2000))
                            for x in np.unique(lengths if transposed
                                               else lengths[a_rows]))
                    record("K11_csr_spgemm_sparse_sddmm", compare(
                        out, spgemm_grad.csr_spgemm_sparse_sddmm_plain(
                            *args), tdt))
                    if not same_bits(out, again):
                        raise AssertionError(f"K11 {tdt} {case[:3]}: runs "
                                             "differ")


def check_k11_presence(rng, record):
    """The presence rule on the card: C's pattern with every other entry
    of every third row dropped, so that some products' entries are
    missing, and Y's values (op(B)'s for the dA form, op(A)'s for the dB
    form) holding +inf, -inf and nan: K11 must skip those products as the
    plain version does (0 * inf would be nan), staged and in place, both
    forms, every value type; the same nan and inf parts, finite entries
    within tolerance, the same bits twice."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    for tdt, npdt in NP_DTYPES.items():
        a, b, (c_ip, c_ix), _, n = k11_operands(rng, K11_CASES[1], npdt,
                                                np.int32, False)
        ip, ix = c_ip.cpu().numpy(), c_ix.cpu().numpy()
        keep = np.ones(ix.size, bool)
        for row in range(0, ip.size - 1, 3):
            keep[ip[row] + 1:ip[row + 1]:2] = False
        rows = np.repeat(np.arange(ip.size - 1), np.diff(ip))[keep]
        c_ip = cuda(np.concatenate([[0], np.cumsum(np.bincount(
            rows, minlength=ip.size - 1))]).astype(np.int32))
        c_ix = cuda(ix[keep])
        g = cuda(values(rng, c_ix.numel(), npdt))
        a, b = list(a), list(b)
        for x, where in ((a, (5, 91, 300)), (b, (7, 40, 333))):
            x[2] = x[2].clone()
            x[2][where[0]] = np.inf
            x[2][where[1]] = -np.inf
            x[2][where[2]] = np.nan
        for transposed in (False, True):
            for budget in K11_BUDGETS[:2]:
                with k11_budget(budget):
                    args = (*a, *b, c_ip, c_ix, g, n, transposed, False)
                    out = k11_call(*args)
                    again = k11_call(*args)
                ref = spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args)
                name = (f"K11 presence {tdt} transposed={transposed} "
                        f"budget={budget}")
                fin = same_parts(name, out, ref)
                record("K11_csr_spgemm_sparse_sddmm",
                       compare(out[fin], ref[fin], tdt))
                if not same_bits(out, again):
                    raise AssertionError(f"{name}: runs differ")


def check_k11_special(rng, record):
    """K11 with inf in G (+inf, -inf, and an imaginary inf for complex
    values), both forms, in every value type: the same nan, +inf and
    -inf parts as the plain version, finite entries within tolerance."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    for tdt, npdt in NP_DTYPES.items():
        a, b, (c_ip, c_ix), g, n = k11_operands(rng, K11_CASES[0], npdt,
                                                np.int32, False)
        g[3] = np.inf
        g[40] = -np.inf
        if np.dtype(npdt).kind == "c":
            g[77] = complex(0.0, np.inf)
        for transposed in (False, True):
            args = (*a, *b, c_ip, c_ix, g, n, transposed, False)
            out = k11_call(*args)
            ref = spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args)
            fin = same_parts(f"K11 {tdt} transposed={transposed}", out, ref)
            record("K11_csr_spgemm_sparse_sddmm", compare(out[fin],
                                                          ref[fin], tdt))


def check_k11_gradcheck():
    """``torch.autograd.gradcheck`` (reverse and forward mode) of
    ``csr_spgemm`` with both operands' values tracked, 6 x 9 by 9 x 7 of
    distinct shuffled columns, in f64 and c128, with and without
    ``triangular``, on the card with the plain versions refused: K4, K5
    and K11 must launch.  Returns the launches."""
    from sparse_dot_tpu_torch.ops import spgemm

    rng = np.random.default_rng(SEED + 15)
    before = read_launches()
    with plain_versions_refused():
        for npdt in (np.float64, np.complex128):
            a_ip, a_ix, a_dv = map(cuda, distinct_rows(
                rng, (3, 0, 2, 5, 1, 4), 9, npdt, np.int32))
            b_ip, b_ix, b_dv = map(cuda, distinct_rows(
                rng, (2, 4, 0, 3, 1, 2, 5, 0, 3), 7, npdt, np.int32))
            for tri in (False, True):
                if not torch.autograd.gradcheck(
                        lambda av, bv, tri=tri: spgemm.csr_spgemm(
                            a_ip, a_ix, av, b_ip, b_ix, bv, 7, tri)[2],
                        (a_dv.clone().requires_grad_(),
                         b_dv.clone().requires_grad_()),
                        check_forward_ad=True):
                    raise AssertionError(f"csr_spgemm gradcheck {npdt}")
    launched = {name: count - before[name]
                for name, count in read_launches().items()}
    if not all(launched[name] > 0 for name in (
            "K4_csr_spgemm_count", "K5_csr_spgemm_fill",
            "K11_csr_spgemm_sparse_sddmm")):
        raise AssertionError(f"csr_spgemm gradcheck launched {launched}")
    return {name: count for name, count in launched.items() if count}


def check_k11_all():
    """Phase 2 for K11 (``--only k11``, and inside ``check_kernels``' run):
    every value type and index width, the inf cases, the presence rule,
    groups of 1 to 32 lanes staged and in place, every mode of
    K11_MODES (a row of C of over 2000 entries in each), and the
    gradcheck of ``csr_spgemm``.  Returns (results, (staged, lanes) seen,
    gradcheck launches)."""
    rng = np.random.default_rng(SEED + 16)
    name = "K11_csr_spgemm_sparse_sddmm"
    results = {name: {"cases": 0, "max_abs_err": 0.0}}

    def record(kernel, err):
        results[kernel]["cases"] += 1
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"],
                                             err)

    lanes_seen, rows_seen = set(), set()
    for tdt, npdt in NP_DTYPES.items():
        for itype in (np.int32, np.int64):
            check_k11(rng, tdt, npdt, itype, record, lanes_seen, rows_seen)
    check_k11_special(rng, record)
    check_k11_presence(rng, record)
    want = {(staged, lanes) for staged in (True, False)
            for lanes in (1, 2, 4, 8, 16, 32)}
    if lanes_seen != want:
        raise AssertionError(f"K11 ran (staged, lanes) {sorted(lanes_seen)}"
                             f", not {sorted(want)}")
    if not K11_MODES <= rows_seen:
        raise AssertionError(f"K11 read the rows {sorted(rows_seen)}, not "
                             f"{sorted(K11_MODES)}")
    return results, sorted(lanes_seen), check_k11_gradcheck()


# ---------------------------------------------------------------------------
# Phase 2: the batched launches of K1, K2, K7 and K8
# ---------------------------------------------------------------------------

# Members of phase 2's batched cases, and of the batch past the grid's
# limit of 65,535 members a launch (two launches).
# ---------------------------------------------------------------------------
# Phase 2 for K12: CSR densify against its plain version
# ---------------------------------------------------------------------------

# (case, m, k, mean row, every empty_every-th row empty, share of explicit
# zeros): rows with repeated and unsorted columns (``random_csr``), empty
# rows, no entry, m or k = 1, an odd width (tiles that start off 16
# bytes), rows wider than shared memory (60,000 columns: 240 KB in f32),
# no row (no launch); ``check_k12`` adds a row exactly TILE_BYTES wide and
# one element wider for each value type.
K12_CASES = (
    ("repeats_unsorted", 300, 200, 5.0, 0, 0.1),
    ("empty_rows", 257, 190, 12.0, 3, 0.0),
    ("no_entry", 40, 30, 0.0, 0, 0.0),
    ("m_1", 1, 500, 80.0, 0, 0.0),
    ("k_1", 500, 1, 2.0, 0, 0.0),
    ("odd_width", 1234, 7, 3.0, 5, 0.1),
    ("wide_60000", 20, 60_000, 300.0, 4, 0.1),
    ("no_row", 0, 10, 0.0, 0, 0.0),
)


def k12_check(name, got, indptr, indices, data, shape, record):
    """K12's output against its plain version: the shape and dtype, the
    same bits wherever a position gets at most one entry, within RTOL
    elsewhere (repeated columns, summed by atomics in any order)."""
    from sparse_dot_tpu_torch.ops import densify

    ref = densify.csr_densify_plain(indptr, indices, data, shape)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"K12 {name}: {tuple(got.shape)} {got.dtype}")
    ones = torch.ones(indices.numel(), dtype=torch.float64,
                      device=data.device)
    single = densify.csr_densify_plain(indptr, indices, ones, shape) <= 1
    if not same_bits(got[single], ref[single]):
        raise AssertionError(f"K12 {name}: bits differ at a position of one "
                             "entry")
    record("K12_csr_densify", compare(got, ref, data.dtype))


def check_k12(record):
    """Phase 2 for K12: ``csr_densify`` in every value type and index
    width on ``K12_CASES`` and at the tile's edge, each launch counted,
    and the transposed use: a CSC's ``dense()`` (its stored arrays
    densified and read as ``.mT``) and a CSR's ``dense(transpose=True)``
    against the plain version of the sorted transposed arrays, and a
    BSR's element CSR."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import densify

    rng = np.random.default_rng(SEED + 12)
    seen = set()
    for tdt, npdt in NP_DTYPES.items():
        edge = densify.TILE_BYTES // tdt.itemsize
        cases = K12_CASES + (("tile_edge", 9, edge, 40.0, 4, 0.0),
                             ("past_tile_edge", 9, edge + 1, 40.0, 4, 0.0))
        for itype in (np.int32, np.int64):
            for name, m, k, mean_row, empty, zeros in cases:
                ip, ix, dv = random_csr(rng, m, k, mean_row, npdt, itype,
                                        empty_every=empty)
                if zeros:
                    dv[rng.random(dv.size) < zeros] = 0
                args = (cuda(ip), cuda(ix), cuda(dv))
                before = densify.csr_densify.launches
                got = densify.csr_densify(*args, (m, k))
                if densify.csr_densify.launches - before != int(m * k > 0):
                    raise AssertionError(f"K12 {name}: launches")
                k12_check(name, got, *args, (m, k), record)
                seen.add(densify.densify_plan(m, k, tdt.itemsize) > 0
                         if m * k else None)
                if tdt == torch.float64:
                    indicator_check(name, args[0], args[1], (m, k), record)
        mat = sps.random(700, 300, density=0.05, format="csr",
                         random_state=rng, dtype=np.float64)
        mat = (mat + 1j * mat if tdt.is_complex else mat).astype(npdt)
        for name, cont, transpose in (
                ("csc", formats.CSC.from_scipy(mat.tocsc()), False),
                ("csc_transposed", formats.CSC.from_scipy(mat.tocsc()), True),
                ("csr_transposed", formats.CSR.from_scipy(mat), True),
                ("bsr", formats.BSR.from_scipy(mat.tobsr((10, 10))), False)):
            got = cont.dense(transpose)
            k12_check(name, got, *cont.csr_arrays(transpose),
                      got.shape, record)
            got = cont.dense_planes(transpose).indicator
            ip, ix, _ = cont.csr_arrays(transpose)
            if not torch.equal(got, densify.csr_indicator_plain(
                    ip, ix, got.shape)):
                raise AssertionError(f"K12 indicator {name} differs")
            record("K12_csr_indicator", 0.0)
    # The indicator at a tile exactly TILE_BYTES wide and one element
    # wider (its 2-byte entries), and a repeated column (set once).
    edge = densify.TILE_BYTES // 2
    for name, k in (("tile_edge", edge), ("past_tile_edge", edge + 1)):
        ip, ix, _ = random_csr(rng, 9, k, 40.0, np.float64)
        indicator_check(name, cuda(ip), cuda(ix), (9, k), record)
    indicator_check("repeat", cuda(np.array([0, 3, 3])),
                    cuda(np.array([2, 2, 0])), (2, 4), record)
    if seen != {True, False, None}:
        raise AssertionError(f"K12 took the paths {seen}")
    return {"tile_and_wide_paths": True}


def indicator_check(name, indptr, indices, shape, record):
    """K12's indicator template against its plain version: the same bf16
    bits, one launch (none for an empty shape)."""
    from sparse_dot_tpu_torch.ops import densify

    before = densify.csr_indicator.launches
    got = densify.csr_indicator(indptr, indices, shape)
    if densify.csr_indicator.launches - before != int(shape[0] * shape[1]
                                                      > 0):
        raise AssertionError(f"K12 indicator {name}: launches")
    want = densify.csr_indicator_plain(indptr, indices, shape)
    if got.dtype != torch.bfloat16 or not torch.equal(got, want):
        raise AssertionError(f"K12 indicator {name} differs from its plain "
                             "version")
    record("K12_csr_indicator", 0.0)


# K13's cases (name, r, n, share of P's positions > 0, triangular, row0,
# P's offset in elements into its buffer): rows 3 (empty) and 5 (full)
# in each; n = 45 (not a multiple of 32 or 8: the scalar path), 256 and
# 1000 (16-byte loads), P one element into a buffer (scalar loads at n %
# 8 == 0), row offsets, no position, n = 1, a row of 70,000 columns, rows
# of 300,000 (work items of 2 steps, no masks kept), no row (no launch).
K13_CASES = (
    ("n_45", 23, 45, 0.4, False, 0, 0),
    ("n_45_triangular_row0", 23, 45, 0.4, True, 7, 0),
    ("vec_n_256", 300, 256, 0.3, False, 0, 0),
    ("vec_triangular", 300, 256, 0.3, True, 0, 0),
    ("vec_triangular_row0", 130, 1000, 0.05, True, 600, 0),
    ("misaligned_p", 64, 512, 0.5, False, 0, 1),
    ("misaligned_triangular", 64, 512, 0.5, True, 3, 1),
    ("none_positive", 40, 300, 0.0, False, 0, 0),
    ("n_1", 500, 1, 0.5, True, 0, 0),
    ("wide_70000", 6, 70_000, 0.02, False, 0, 0),
    ("wide_300000", 3, 300_000, 0.01, True, 1000, 0),
    ("no_row", 0, 10, 0.5, False, 0, 0),
)


def k13_operands(rng, r, n, share, npdt, offset):
    """(C, P) on the card: P a bf16 count with ``share`` of its positions
    in 1..299 (rows 3 and 5 empty and full where they exist), ``offset``
    elements into its buffer; C random with an exact zero at a stored
    position of row 5."""
    counts = rng.integers(1, 300, (r, n)) * (rng.random((r, n)) < share)
    if r > 5:
        counts[3] = 0
        counts[5] = 1
    p = torch.zeros(r * n + offset, dtype=torch.bfloat16, device="cuda")
    p[offset:] = cuda(counts.reshape(-1).astype(np.float32)).to(
        torch.bfloat16)
    c = values(rng, (r, n), npdt)
    if r > 5:
        c[5, 0] = 0
    return cuda(c), p[offset:].view(r, n)


def k13_call(c, p, triangular, row0, itype):
    """``csr_compact`` through its wrapper, its launches counted: (arrays,
    launches)."""
    from sparse_dot_tpu_torch.ops import compact

    before = compact.masked_compact.launches
    got = compact.csr_compact(c, p, triangular, row0, itype)
    return got, compact.masked_compact.launches - before


def k13_check(name, c, p, triangular, row0, itype, record):
    """K13 against its plain version: equal indptr and indices, the same
    bits of data (a gather), one launch (none where the area holds no
    position), a second call the same bits."""
    from sparse_dot_tpu_torch.ops import compact

    got, launched = k13_call(c, p, triangular, row0, itype)
    again = compact.csr_compact(c, p, triangular, row0, itype)
    want = compact.csr_compact_plain(c, p, triangular, row0, itype)
    torch.cuda.synchronize()
    nnz = int(want[0][-1])
    if launched != int(compact.area(*p.shape, triangular, row0) > 0):
        raise AssertionError(f"K13 {name}: launches {launched}")
    for g, a, w in zip(got, again, want):
        if g.dtype != w.dtype or not (same_bits(g, w) and same_bits(a, w)):
            raise AssertionError(f"K13 {name}: differs from its plain "
                                 "version")
    record("K13_csr_compact", 0.0)
    return nnz


def graph_and_stream(c, p, record):
    """K13 at case a captured in a CUDA graph and replayed twice (its
    workspace, made in the capture, left 0 by each replay), and launched on
    a second stream (its own workspace), each equal to the plain version
    bit for bit."""
    from sparse_dot_tpu_torch.ops import compact

    want = compact.csr_compact_plain(c, p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        *arrays, total = compact.masked_compact(c, p)
    runs = []
    for _ in range(2):
        graph.replay()
        runs.append(("graph replay", compact.cut(arrays, int(total),
                                                 p.shape[1])))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(("second stream", compact.csr_compact(c, p)))
    torch.cuda.synchronize()
    for name, got in runs:
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K13 {name}: differs from its plain "
                                 "version")
        record("K13_csr_compact", 0.0)


def check_k13(record):
    """Phase 2 for K13: ``csr_compact`` on ``K13_CASES`` in every value type
    and index width, and at case a (the demo X @ X.T's C and P, with and
    without ``triangular``), each with P's masks staged in shared memory
    and with none (``STAGE_BYTES`` 0: P read again in the fill); both load
    paths of each seen."""
    from sparse_dot_tpu_torch import formats

    from sparse_dot_tpu_torch.ops import compact

    rng = np.random.default_rng(SEED + 13)
    paths, steps_an_item = set(), set()
    stage_bytes = compact.STAGE_BYTES
    try:
        # Every case twice: masks staged in shared memory where the plan
        # says so, then with no stage, P read again in the fill.
        for stage in (stage_bytes, 0):
            compact.STAGE_BYTES = stage
            for tdt, npdt in NP_DTYPES.items():
                for itype in (torch.int32, torch.int64):
                    for name, r, n, share, tri, row0, offset in K13_CASES:
                        c, p = k13_operands(rng, r, n, share, npdt, offset)
                        k13_check(f"{name}_stage_{stage}", c, p, tri, row0,
                                  itype, record)
                        if r * n:
                            plan = compact.compact_plan(r, n)
                            paths.add((n % 8 == 0 and p.data_ptr() % 16 == 0,
                                       plan[2]))
                            steps_an_item.add(plan[1])
            planes = formats.to_device(demo_x()).dense_planes()
            c = planes.dense @ planes.dense.mT
            p = planes.indicator @ planes.indicator.mT
            for tri in (False, True):
                k13_check(f"case_a_triangular_{tri}_stage_{stage}", c, p,
                          tri, 0, torch.int32, record)
    finally:
        compact.STAGE_BYTES = stage_bytes
    graph_and_stream(c, p, record)
    if len(paths) != 4 or len(steps_an_item) < 2:
        raise AssertionError(f"K13 took the paths (16-byte loads, staged) "
                             f"{sorted(paths)}, steps an item "
                             f"{sorted(steps_an_item)}")
    return {"loads_by_stage": sorted(paths),
            "steps_an_item": sorted(steps_an_item)}


BATCH = 5
BIG_BATCH = 70_000
# Which operands a batched case gives with a member dimension: for K1 and
# K2 (values, b, c0: None, "shared" or "batched"), for K7 and K8 (g, b).
SPMM_COMBOS = ((True, False, None), (True, True, "batched"),
               (False, True, "shared"), (True, False, "shared"),
               (False, False, "batched"))
SDDMM_COMBOS = ((True, False), (True, True), (False, True))


def odd_members(x):
    """A copy of the batch x (B, ...) whose members lie one element further
    apart than their size: each member contiguous, but (except for c128)
    not on 16 bytes, so the kernels take their scalar path."""
    inner = x[0].numel()
    buf = torch.zeros(x.shape[0] * (inner + 1), dtype=x.dtype,
                      device=x.device)
    view = buf.as_strided(x.shape, (inner + 1, *x[0].stride()))
    view.copy_(x)
    return view


def batched_call(wrapper, launches, fn, *args):
    """fn(*args), checked to make ``launches`` batched launches (counted in
    ``wrapper.launches_batched``) and run twice for the same bits."""
    before = wrapper.launches_batched
    out = fn(*args)
    made = wrapper.launches_batched - before
    if made != launches:
        raise AssertionError(f"{fn.__name__}: {made} batched launches, "
                             f"expected {launches}")
    if not torch.equal(out, fn(*args)):
        raise AssertionError(f"{fn.__name__}: runs differ")
    return out


def member_operands(rng, npdt, shapes, batched, odd):
    """Operands of ``shapes`` on the card, each with BATCH members ahead
    where ``batched`` says so (None: no operand), as ``odd_members``
    views with ``odd``."""
    out = []
    for shape, how in zip(shapes, batched):
        if how is None or how is False:
            out.append(None if how is None else cuda(values(rng, shape,
                                                            npdt)))
            continue
        if how == "shared":
            out.append(cuda(values(rng, shape, npdt)))
            continue
        x = cuda(values(rng, (BATCH, *shape), npdt))
        out.append(odd_members(x) if odd else x)
    return out


def check_bsr_batched(rng, tdt, npdt, itype, alpha, record):
    """K1 and K8 batched (``spmm_batched``, ``sddmm_batched``) against
    their batched plain versions in ``tdt`` at bs 8 (a split block row),
    3 (the CUDA cores) and 64 (split; complex values in two row tiles of
    32), n in {1, 37, 64}, with shared and batched operands
    (``SPMM_COMBOS``, ``SDDMM_COMBOS``) at even and odd member strides;
    each call's variant checked by the launch counts."""
    from sparse_dot_tpu_torch.ops import bsr

    for bs, nbrows, nbcols, per_row, empty_every, split in (
            (8, 24, 20, 3, 5, True), (3, 30, 20, 3, 4, False),
            (64, 8, 6, 1, 3, True)):
        indptr, indices, _ = random_bsr(rng, nbrows, nbcols, bs, per_row,
                                        npdt, itype, empty_every, split)
        ip, ix = cuda(indptr), cuda(indices)
        nb = len(indices)
        tc = bsr.uses_tensor_cores(tdt, bs)
        k1 = variant_name("K1_bsr_spmm", tdt, bs)
        for n in (1, 37, 64):
            for combo in SPMM_COMBOS:
                for odd in (False, True):
                    data, b, c0 = member_operands(
                        rng, npdt, ((nb, bs, bs), (nbcols * bs, n),
                                    (nbrows * bs, n)), combo, odd)
                    args = (ip, ix, data, b, alpha, 2.0, c0)
                    before = bsr.bsr_spmm.launches_tc
                    out = batched_call(bsr.bsr_spmm, 1, bsr.spmm_batched,
                                       *args)
                    if (bsr.bsr_spmm.launches_tc - before) != 2 * tc:
                        raise AssertionError(f"batched {k1}: variant")
                    record(k1, compare(
                        out, bsr.bsr_spmm_batched_plain(*args), tdt))
            for g_b, b_b in SDDMM_COMBOS:
                for odd in (False, True):
                    g, b = member_operands(
                        rng, npdt, ((nbrows * bs, n), (nbcols * bs, n)),
                        (g_b, b_b), odd)
                    before = bsr.bsr_sddmm.launches_tc
                    out = batched_call(bsr.bsr_sddmm, 1,
                                       bsr.sddmm_batched, ip, ix, g, b,
                                       bs, alpha)
                    if (bsr.bsr_sddmm.launches_tc - before) != 2 * tc:
                        raise AssertionError("batched K8: variant")
                    record(k8_name(tdt, bs), compare(
                        out, bsr.bsr_sddmm_batched_plain(
                            ip, ix, g, b, bs, alpha), tdt))


def check_batched(record):
    """Phase 2 for the batched launches: K2, K7, K1 and K8 (each variant)
    against their batched plain versions in every value type, with
    shared and batched operands (``SPMM_COMBOS``, ``SDDMM_COMBOS``),
    alpha, beta and c0, members at odd strides (the scalar path), K2 and
    K7 over a row past 3x K2's chunk (split: each member's own counts
    and partial rows), K1 over a split block row (each member's own
    workspace slots); every call run twice for the same bits; then the
    sparse x sparse kernels K5, K6, K9 and K11 (``check_batched_spgemm``);
    then a batch of BIG_BATCH tiny members through each, two launches.
    Returns ({kernel: (16-byte paths seen, scalar paths seen)}, the
    sparse x sparse plans seen)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr, csr, sddmm

    rng = np.random.default_rng(SEED + 17)
    paths = {}
    k7_shared = set()  # (operand shared, members a group) seen by K7

    def path(name, vec):
        paths.setdefault(name, set()).add(vec > 1)

    for tdt, npdt in NP_DTYPES.items():
        itype = np.int64 if tdt in (torch.float64, torch.complex64) \
            else np.int32
        cplx = np.dtype(npdt).kind == "c"
        alpha = 0.5 - 0.25j if cplx else -1.5
        for m, k, mean_row, empty_every, long_row in (
                (300, 200, 3, 5, 0), (257, 190, 12, 0, 3500)):
            indptr, indices, _ = random_csr(rng, m, k, mean_row, npdt, itype,
                                            empty_every, long_row)
            ip, ix = cuda(indptr), cuda(indices)
            nnz = len(indices)
            plan = formats.csr_plan(ip, nnz)
            if long_row and long_row < 3 * plan.chunk:
                raise AssertionError("batched K2: the long row is too short")
            for n in (1, 4, 17, 64):
                for combo in SPMM_COMBOS:
                    for odd in (False, True):
                        data, b, c0 = member_operands(
                            rng, npdt, ((nnz,), (k, n), (m, n)), combo, odd)
                        args = (ip, ix, data, b, alpha, 2.0, c0)
                        out = batched_call(csr.csr_spmm, 1,
                                           csr.spmm_batched, *args, plan)
                        record("K2_csr_spmm", compare(
                            out, csr.csr_spmm_batched_plain(*args), tdt))
                        path("K2", csr.spmm_schedule(
                            n, tdt, nnz / m, csr.aligned_members(
                                *((t, csr.member_stride("", t, core))
                                  for t, core in ((b, 2), (c0, 2)))
                            )).vec)
                transpose = formats.CsrPattern(ip, ix, k).transpose
                for g_b, b_b in SDDMM_COMBOS:
                    for odd in (False, True):
                        g, b = member_operands(rng, npdt, ((m, n), (k, n)),
                                               (g_b, b_b), odd)
                        strides = (csr.member_stride("", g, 2),
                                   csr.member_stride("", b, 2))
                        aligned = csr.aligned_members((g, strides[0]),
                                                      (b, strides[1]))
                        for al in (None, alpha):
                            out = batched_call(sddmm.csr_sddmm, 1,
                                               sddmm.sddmm_batched, ip, ix,
                                               g, b, al)
                            want = sddmm.csr_sddmm_batched_plain(
                                ip, ix, g, b, al)
                            record("K7_csr_sddmm", compare(out, want, tdt))
                            if g_b:
                                continue
                            # G shared: the roles swapped on A's transpose
                            # where b's members can share a launch group.
                            out = batched_call(
                                sddmm.csr_sddmm, 1, sddmm.sddmm_batched, ip,
                                ix, g, b, al, transpose)
                            record("K7_csr_sddmm", compare(out, want, tdt))
                            swap = sddmm.batched_schedule(
                                n, tdt, nnz, BATCH, (strides[1], 0),
                                aligned, ix.element_size())[1]
                            k7_shared.add(("g", swap))
                        members = sddmm.batched_schedule(
                            n, tdt, nnz, BATCH, strides, aligned,
                            ix.element_size())[1]
                        k7_shared.add(("b" if not b_b else "none",
                                       members))
                        path("K7", sddmm.sddmm_schedule(
                            n, tdt, nnz, aligned).vec)
        check_bsr_batched(rng, tdt, npdt, itype, alpha, record)
    for name, want in (("K2", {True, False}), ("K7", {True, False})):
        if paths.get(name) != want:
            raise AssertionError(f"batched {name} took only the "
                                 f"{paths.get(name)} 16-byte paths")
    if not {("b", 2), ("b", 4), ("g", 2), ("g", 4), ("none", 1),
            ("b", 1)} <= k7_shared:
        raise AssertionError(f"batched K7 took only {sorted(k7_shared)}")
    spgemm_seen = check_batched_spgemm(record)
    spgemm_seen["member_groups"] = check_groups(record)
    check_big_batch(record)
    paths = {name: sorted(seen) for name, seen in paths.items()}
    paths["K7_shared_members"] = sorted(k7_shared)
    return paths, spgemm_seen


def check_big_batch(record):
    """BIG_BATCH members of a tiny pattern through each batched wrapper:
    two launches each (65,535 members, then the rest), against the
    batched plain versions (K5, K6, K9 and K11 also twice for the same
    bits)."""
    from sparse_dot_tpu_torch.ops import bsr, csr, sddmm, spgemm, spgemm_grad

    rng = np.random.default_rng(SEED + 18)
    indptr, indices, _ = random_csr(rng, 3, 2, 2, np.float64)
    ip, ix = cuda(indptr), cuda(indices)
    data = cuda(values(rng, (BIG_BATCH, len(indices)), np.float64))
    b = cuda(values(rng, (2, 1), np.float64))
    out = batched_call(csr.csr_spmm, 2, csr.spmm_batched, ip, ix, data, b)
    record("K2_csr_spmm", compare(out, csr.csr_spmm_batched_plain(
        ip, ix, data, b), torch.float64))
    g = cuda(values(rng, (BIG_BATCH, 3, 1), np.float64))
    out = batched_call(sddmm.csr_sddmm, 2, sddmm.sddmm_batched, ip, ix, g, b)
    record("K7_csr_sddmm", compare(out, sddmm.csr_sddmm_batched_plain(
        ip, ix, g, b), torch.float64))
    # n = 8: B shared, 4 members a group; G shared, the roles swapped (on
    # a generator of their own, so that the cases after keep their data).
    rng8 = np.random.default_rng(SEED + 21)
    g = cuda(values(rng8, (BIG_BATCH, 3, 8), np.float64))
    b8 = cuda(values(rng8, (2, 8), np.float64))
    out = batched_call(sddmm.csr_sddmm, 2, sddmm.sddmm_batched, ip, ix, g,
                       b8)
    record("K7_csr_sddmm", compare(out, sddmm.csr_sddmm_batched_plain(
        ip, ix, g, b8), torch.float64))
    from sparse_dot_tpu_torch import formats

    bb = cuda(values(rng8, (BIG_BATCH, 2, 8), np.float64))
    out = batched_call(sddmm.csr_sddmm, 2, sddmm.sddmm_batched, ip, ix,
                       g[0], bb, None, formats.CsrPattern(ip, ix, 2).transpose)
    record("K7_csr_sddmm", compare(out, sddmm.csr_sddmm_batched_plain(
        ip, ix, g[0], bb), torch.float64))
    del g, b8, bb
    for bs, npdt in ((8, np.float64), (3, np.complex128)):
        tdt = torch.from_numpy(np.zeros(0, npdt)).dtype
        indptr, indices, _ = random_bsr(rng, 2, 2, bs, 1, npdt)
        ip, ix = cuda(indptr), cuda(indices)
        data = cuda(values(rng, (BIG_BATCH, len(indices), bs, bs), npdt))
        b = cuda(values(rng, (2 * bs, 1), npdt))
        out = batched_call(bsr.bsr_spmm, 2, bsr.spmm_batched, ip, ix, data,
                           b)
        k1 = variant_name("K1_bsr_spmm", tdt, bs)
        record(k1, compare(out, bsr.bsr_spmm_batched_plain(ip, ix, data, b),
                           tdt))
        g = cuda(values(rng, (BIG_BATCH, 2 * bs, 1), npdt))
        out = batched_call(bsr.bsr_sddmm, 2, bsr.sddmm_batched, ip, ix, g, b,
                           bs)
        record(k8_name(tdt, bs), compare(out, bsr.bsr_sddmm_batched_plain(
            ip, ix, g, b, bs), tdt))
    # The sparse x sparse kernels on a 3 x 2 op(A) times a 2 x 2 op(B).
    a_ip, a_ix, a_dv = map(cuda, distinct_rows(rng, (1, 2, 0), 2, np.float64,
                                               np.int32))
    b_ip, b_ix, b_dv = map(cuda, distinct_rows(rng, (2, 1), 2, np.float64,
                                               np.int32))
    av = cuda(values(rng, (BIG_BATCH, a_ix.numel()), np.float64))
    c_ip, c_ix, _ = spgemm.product(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, 2)
    f64 = torch.float64
    _, out = spgemm_batched_call(
        spgemm.csr_spgemm_fill, 2, "K5", spgemm.fill_batched, a_ip, a_ix, av,
        b_ip, b_ix, b_dv, 2, None, c_ip, c_ix.numel())
    record("K5_csr_spgemm_fill", compare(
        out, spgemm.csr_spgemm_fill_batched_plain(a_ip, a_ix, av, b_ip, b_ix,
                                                  b_dv, 2)[1], f64))
    # K6 over a 1 x 2 op(A) and a 2 x 1000 op(B): rows cut into windows,
    # whose start table the first launch builds and the second reads.
    w_ip, w_ix, _ = map(cuda, distinct_rows(rng, (2,), 2, np.float64,
                                            np.int32))
    wb_ip, wb_ix, wb_dv = map(cuda, distinct_rows(rng, (40, 40), 1000,
                                                  np.float64, np.int32))
    wv = cuda(values(rng, (BIG_BATCH, 2), np.float64))
    out = spgemm_batched_call(
        spgemm.csr_spgemm_dense, 2, "K6", spgemm.spgemm_dense_batched, w_ip,
        w_ix, wv, wb_ip, wb_ix, wb_dv, 1000)
    if not spgemm.csr_spgemm_dense.last_table:
        raise AssertionError("batched K6: no window-start table")
    record("K6_csr_spgemm_dense", compare(
        out, spgemm.csr_spgemm_dense_batched_plain(w_ip, w_ix, wv, wb_ip,
                                                   wb_ix, wb_dv, 1000), f64))
    del out, wv
    d = cuda(values(rng, (BIG_BATCH, 3, 2), np.float64))
    out = spgemm_batched_call(
        spgemm_grad.csr_spgemm_sddmm, 2, "K9", spgemm_grad.sampled_batched,
        a_ip, a_ix, d, b_ip, b_ix, b_dv)
    record("K9_csr_spgemm_sddmm", compare(
        out, spgemm_grad.csr_spgemm_sddmm_batched_plain(
            a_ip, a_ix, d, b_ip, b_ix, b_dv), f64))
    g = cuda(values(rng, (BIG_BATCH, c_ix.numel()), np.float64))
    for transposed in (False, True):
        args = (a_ip, a_ix, av, b_ip, b_ix, b_dv, c_ip, c_ix, g, 2,
                transposed)
        out = spgemm_batched_call(
            spgemm_grad.csr_spgemm_sparse_sddmm, 2, "K11",
            spgemm_grad.sparse_sampled_batched, *args)
        record("K11_csr_spgemm_sparse_sddmm", compare(
            out, spgemm_grad.csr_spgemm_sparse_sddmm_batched_plain(*args),
            f64))


# Phase 2's batched sparse x sparse cases: (m, k, n, op(A)'s row lengths,
# op(B)'s), rows of distinct shuffled columns.  The first puts K5's rows in
# every bin (up to a dense row in the device workspace) and cuts K6's rows
# into windows; the second splits K6's rows across warps; the third is
# many short rows (K5's register bins, K9's and K11's staged runs); the
# fourth has rows of C past 2000 entries (K11's long lines).
SPGEMM_BATCH_CASES = (
    (42, 2000, 100_000, (0, 1, 3, 10, 40, 150, 600), (20,)),
    (3, 3000, 300, (1200, 2000, 1500), (20,)),
    (300, 200, 150, (3, 0, 5, 2), (4, 6, 0, 3)),
    (20, 30, 3000, (2,) * 10 + (30,) + (2,) * 9, (150,)),
)
# Which of op(A)'s and op(B)'s values (and K6's c0: None, "shared" or
# "batched") a batched case gives with a member dimension; for K9 and K11
# (d or G, Y's values).
K6_COMBOS = ((True, False, None), (True, True, "batched"),
             (False, True, "shared"), (False, False, "batched"))
PAIR_COMBOS = ((True, False), (False, True), (True, True))


def spgemm_batched_call(wrapper, launches, name, fn, *args):
    """fn(*args) of a batched sparse x sparse wrapper, checked to make
    ``launches`` batched launches (``wrapper.launches_batched``) and run
    twice for the same bits (nan included); K5's (indices, data) checked
    on its data, the indices equal."""
    before = wrapper.launches_batched
    out = fn(*args)
    made = wrapper.launches_batched - before
    if made != launches:
        raise AssertionError(f"{name}: {made} batched launches, expected "
                             f"{launches}")
    again = fn(*args)
    pairs = tuple(zip(out, again)) if isinstance(out, tuple) else (
        (out, again),)
    if not all(same_bits(x, y) if x.is_floating_point() or x.is_complex()
               else torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"{name}: runs differ")
    return out


def check_batched_spgemm(record, budgets=(None, 0)):
    """Phase 2 for the batched sparse x sparse launches: K5
    (``fill_batched``, its indices equal to the single product's), K6
    (``spgemm_dense_batched``, with and without ``triangular`` and the
    alpha/beta/c0 epilogue, over op(B) sorted and shuffled), K9
    (``sampled_batched``, both forms, with and without alpha) and K11
    (``sparse_sampled_batched``, both forms, with and without
    ``triangular``) against their batched plain versions at every case of
    SPGEMM_BATCH_CASES, in every value type (int64 indices for f64 and
    c64, int32 for the others), with shared and per-member operands
    (``K6_COMBOS``, ``PAIR_COMBOS``), members at odd strides, K9's and
    K11's lines staged and read in place (``budgets``); every call run
    twice for the same bits, one batched launch each.  Returns the K6
    plans and the (form, staged) of K9 and K11 seen."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm, spgemm_grad

    rng = np.random.default_rng(SEED + 24)
    seen = {"K6": set(), "K9": set(), "K11": set()}
    for tdt, npdt in NP_DTYPES.items():
        itype = np.int64 if tdt in (torch.float64, torch.complex64) \
            else np.int32
        alpha = 0.5 - 0.25j if np.dtype(npdt).kind == "c" else -1.5
        for m, k, n, a_rows, b_rows in SPGEMM_BATCH_CASES:
            a = distinct_rows(rng, np.resize(a_rows, m), k, npdt, itype)
            b = distinct_rows(rng, np.resize(b_rows, k), n, npdt, itype)
            a_ip, a_ix, a_dv = map(cuda, a)
            b_ip, b_ix, b_dv = map(cuda, b)
            bs_ix = cuda(sorted_rows(*b)[1])
            by_column = cuda(np.lexsort(
                (b[1], np.repeat(np.arange(k), np.diff(b[0])))))
            plan = spgemm.spgemm_plan(a_ip, a_ix, b_ip, n, tdt, a_ip.dtype)
            shapes = ((a[1].size,), (b[1].size,))
            for tri in (False, True):
                c_ip, c_ix, _ = spgemm.product(a_ip, a_ix, a_dv, b_ip, b_ix,
                                               b_dv, n, tri)
                nnz = c_ix.numel()
                for odd in (False, True):
                    for combo in PAIR_COMBOS:
                        av, bv = member_operands(rng, npdt, shapes, combo,
                                                 odd)
                        idx, out = spgemm_batched_call(
                            spgemm.csr_spgemm_fill, int(nnz > 0), "K5",
                            spgemm.fill_batched, a_ip, a_ix, av, b_ip, b_ix,
                            bv, n, plan, c_ip, nnz, tri)
                        ref = spgemm.csr_spgemm_fill_batched_plain(
                            a_ip, a_ix, av, b_ip, b_ix, bv, n, tri)
                        if not (torch.equal(idx, c_ix)
                                and torch.equal(idx, ref[0])):
                            raise AssertionError(f"batched K5 {tdt} m={m}: "
                                                 "indices differ")
                        record("K5_csr_spgemm_fill",
                               compare(out, ref[1], tdt))
                    av, bv, g = member_operands(
                        rng, npdt, (*shapes, (nnz,)), (True,) * 3, odd)
                    for g_b, y_b in PAIR_COMBOS:
                        for transposed in (False, True):
                            y = (av if transposed else bv) if y_b else (
                                av[0] if transposed else bv[0])
                            check_k11_batched(
                                record, seen, budgets, tdt, a_ip, a_ix,
                                y if transposed else a_dv, b_ip, b_ix,
                                b_dv if transposed else y, c_ip, c_ix,
                                g if g_b else g[0], n, transposed, tri)
            for odd in (False, True):
                for combo in K6_COMBOS:
                    av, bv, c0 = member_operands(rng, npdt, (*shapes, (m, n)),
                                                 combo, odd)
                    for tri in (False, True):
                        for srt in (False, True):
                            bix, bvv = ((bs_ix, bv[..., by_column]
                                         .contiguous()) if srt
                                        else (b_ix, bv))
                            for al, be in ((None, None), (alpha, 2.0)):
                                cc = None if be is None else c0
                                if cc is None and not (combo[0] or
                                                       combo[1]):
                                    continue
                                args = (a_ip, a_ix, av, b_ip, bix, bvv, n,
                                        al, be, cc, tri, srt)
                                out = spgemm_batched_call(
                                    spgemm.csr_spgemm_dense, 1, "K6",
                                    spgemm.spgemm_dense_batched, *args)
                                used = spgemm.csr_spgemm_dense.last_plan
                                seen["K6"].add((used.splits > 1,
                                                used.windows > 1, srt, tri))
                                ref = spgemm.csr_spgemm_dense_batched_plain(
                                    a_ip, a_ix, av, b_ip, bs_ix,
                                    bv[..., by_column], n, al, be, cc, tri)
                                record("K6_csr_spgemm_dense",
                                       compare(out, ref, tdt))
                # K9: d = G (m, n); dA with Y = op(B), dB with Y = op(A)^T.
                t, order = formats.CsrPattern(a_ip, a_ix, k).transpose()
                for d_b, y_b in PAIR_COMBOS:
                    d, av, bv = member_operands(
                        rng, npdt, ((m, n), *shapes), (d_b, y_b, y_b), odd)
                    for transposed in (False, True):
                        p_arr, y_arr = ((b_ip, b_ix), (
                            t.indptr, t.indices, av[..., order].contiguous())
                        ) if transposed else ((a_ip, a_ix), (b_ip, b_ix, bv))
                        for budget in budgets:
                            with k9_budget(budget):
                                staged = k9_plan(d[0] if d_b else d,
                                                 *y_arr[:2],
                                                 transposed).staged
                                for al in (None, alpha):
                                    args = (*p_arr, d, *y_arr, al,
                                            transposed)
                                    out = spgemm_batched_call(
                                        spgemm_grad.csr_spgemm_sddmm,
                                        int(p_arr[1].numel() > 0), "K9",
                                        spgemm_grad.sampled_batched, *args)
                                    record("K9_csr_spgemm_sddmm", compare(
                                        out, spgemm_grad
                                        .csr_spgemm_sddmm_batched_plain(
                                            *args), tdt))
                            seen["K9"].add((transposed, staged))
    check_seen_batched(seen)
    groups = check_grouped_sampled(record)
    return {**{name: sorted(map(list, got)) for name, got in seen.items()},
            "K9_K11_groups": [list(g) for g in groups]}


def check_k11_batched(record, seen, budgets, tdt, a_ip, a_ix, a_dv, b_ip,
                      b_ix, b_dv, c_ip, c_ix, g, n, transposed, triangular):
    """One batched K11 form under each of ``budgets``, against its batched
    plain version; ``seen`` collects (form, staged)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    args = (a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, c_ip, c_ix, g, n,
            transposed, triangular)
    p_nnz = (b_ix if transposed else a_ix).numel()
    for budget in budgets:
        with k11_budget(budget):
            staged = k11_plan((a_ip, a_ix, a_dv), (b_ip, b_ix, b_dv), g, n,
                              transposed).staged
            out = spgemm_batched_call(
                spgemm_grad.csr_spgemm_sparse_sddmm, int(p_nnz > 0), "K11",
                spgemm_grad.sparse_sampled_batched, *args)
        seen["K11"].add((transposed, staged))
        record("K11_csr_spgemm_sparse_sddmm", compare(
            out, spgemm_grad.csr_spgemm_sparse_sddmm_batched_plain(*args),
            tdt))


def check_seen_batched(seen):
    """The batched checks reached K6's split rows, windows, sorted and
    shuffled op(B) with and without ``triangular``, and K9's and K11's
    both forms staged and in place."""
    k6 = seen["K6"]
    if not ({s[0] for s in k6} == {s[1] for s in k6} == {False, True}
            and {s[2:] for s in k6} == {(x, y) for x in (False, True)
                                        for y in (False, True)}):
        raise AssertionError(f"batched K6 ran only {sorted(k6)}")
    want = {(x, y) for x in (False, True) for y in (False, True)}
    for name in ("K9", "K11"):
        if seen[name] != want:
            raise AssertionError(f"batched {name} ran only "
                                 f"{sorted(seen[name])}")


# Phase 2's member groups of batched K9 and K11 (``spgemm_grad.
# group_plan``): (m, k, n, op(A)'s row lengths, op(B)'s).  The first has
# rows of op(B) of ~30 entries (16 lanes, so 4 members a group in the dA
# forms) and one of 120, past what a group's lanes hold in registers,
# and columns of op(A) of ~13 (8 lanes: 4 members for K9's dB form, one
# member a block for K11's, which groups from 32 lanes); the second
# columns of op(A) of ~75 (32 lanes: groups in both dB forms).  With Y's
# values per member the batch runs one member a block.  A batch of 2
# takes a group of 2; 3 and 5 leave a last group part full.
GROUP_CASES = ((120, 90, 200, (3, 0, 5, 12, 30), (10, 14, 0, 6, 120)),
               (150, 40, 64, (20, 12, 28), (20, 30, 10)))
GROUP_BATCHES = (2, 3, 5)


def batch_of(rng, npdt, size, shape, batched, odd):
    """Values of ``shape`` on the card: ``size`` members ahead where
    ``batched`` (as ``odd_members`` views with ``odd``), else one set
    that every member shares."""
    if not batched:
        return cuda(values(rng, shape, npdt))
    x = cuda(values(rng, (size, *shape), npdt))
    return odd_members(x) if odd else x


def check_grouped_sampled(record):
    """Batched K9 (``sampled_batched``, both forms, with and without
    alpha) and K11 (``sparse_sampled_batched``, both forms, with and
    without ``triangular``) on the plan ``group_plan`` gives them, against
    their batched plain versions at each case of GROUP_CASES, in every
    value type and both index widths, at GROUP_BATCHES members (a last
    group part full), with D (G) and Y's values each shared or per member
    (``PAIR_COMBOS``), members at odd strides; each call run twice for
    the same bits, one batched launch.  Returns the (kernel, dB form,
    members, Y's values shared) seen, and raises unless each kernel ran
    2 and 4 members a group (Y's values shared) and one member a block
    with Y's values per member, in both forms."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm, spgemm_grad

    k11_plain = spgemm_grad.csr_spgemm_sparse_sddmm_batched_plain
    rng = np.random.default_rng(SEED + 26)
    seen = set()
    for tdt, npdt in NP_DTYPES.items():
        alpha = 0.5 - 0.25j if np.dtype(npdt).kind == "c" else -1.5
        for itype in (np.int32, np.int64):
            for m, k, n, a_rows, b_rows in GROUP_CASES:
                a = distinct_rows(rng, np.resize(a_rows, m), k, npdt, itype)
                b = distinct_rows(rng, np.resize(b_rows, k), n, npdt, itype)
                a_ip, a_ix, a_dv = map(cuda, a)
                b_ip, b_ix, b_dv = map(cuda, b)
                t, order = formats.CsrPattern(a_ip, a_ix, k).transpose()
                cs = {tri: spgemm.product(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv,
                                          n, tri)[:2] for tri in (False, True)}
                for size in GROUP_BATCHES:
                    odd = size != 5
                    for d_b, y_b in PAIR_COMBOS:
                        d = batch_of(rng, npdt, size, (m, n), d_b, odd)
                        av = batch_of(rng, npdt, size, a[1].shape, y_b, odd)
                        bv = batch_of(rng, npdt, size, b[1].shape, y_b, odd)
                        gs = {tri: batch_of(rng, npdt, size,
                                            (c[1].numel(),), d_b, odd)
                              for tri, c in cs.items()}
                        for transposed in (False, True):
                            p_arr, y_arr = ((b_ip, b_ix), (
                                t.indptr, t.indices,
                                av[..., order].contiguous())
                            ) if transposed else ((a_ip, a_ix),
                                                  (b_ip, b_ix, bv))
                            plan = spgemm_grad.group_plan(
                                k9_plan(d[0] if d_b else d, *y_arr[:2],
                                        transposed),
                                d.element_size(), size, not d_b, not y_b)
                            seen.add(("K9", transposed, plan.members,
                                      not y_b))
                            args = (*p_arr, d, *y_arr,
                                    alpha if odd else None, transposed)
                            out = spgemm_batched_call(
                                spgemm_grad.csr_spgemm_sddmm, 1, "K9",
                                spgemm_grad.sampled_batched, *args)
                            record("K9_csr_spgemm_sddmm", compare(
                                out, spgemm_grad
                                .csr_spgemm_sddmm_batched_plain(*args),
                                tdt))
                        for tri, (c_ip, c_ix) in cs.items():
                            for transposed in (False, True):
                                args = (a_ip, a_ix,
                                        av if transposed else a_dv,
                                        b_ip, b_ix,
                                        b_dv if transposed else bv,
                                        c_ip, c_ix, gs[tri], n, transposed,
                                        tri)
                                plan = spgemm_grad.sparse_group_plan(
                                    k11_plan((a_ip, a_ix, a_dv),
                                             (b_ip, b_ix, b_dv), gs[tri],
                                             n, transposed),
                                    gs[tri].element_size(), size,
                                    (not d_b, not y_b), transposed)
                                seen.add(("K11", transposed, plan.members,
                                          not y_b))
                                out = spgemm_batched_call(
                                    spgemm_grad.csr_spgemm_sparse_sddmm, 1,
                                    "K11", spgemm_grad.sparse_sampled_batched,
                                    *args)
                                record("K11_csr_spgemm_sparse_sddmm",
                                       compare(out, k11_plain(*args), tdt))
    for name in ("K9", "K11"):
        want = {(name, t, m, y) for t in (False, True)
                for m, y in ((2, True), (4, True), (1, False))}
        if not want <= seen:
            raise AssertionError(f"batched {name} ran no group of "
                                 f"{sorted(want - seen)}")
    return sorted(seen)


# Phase 2's member groups of batched K2 and K5 (``csr.spmm_group``,
# ``spgemm.fill_groups``): batch sizes (1 runs one member a block; 3 and
# 5 leave a last group part full; 5 at odd member strides), and value and
# index types.
GROUP_SIZES = (1, 3, 4, 5, 16)
# K5's batches: (members, most members a block or None for the wrapper's).
K5_GROUP_RUNS = tuple((size, None) for size in GROUP_SIZES) + ((5, 2),)
GROUP_TYPES = ((torch.float32, np.int32), (torch.float32, np.int64),
               (torch.float64, np.int32), (torch.float64, np.int64),
               (torch.complex128, np.int32), (torch.complex128, np.int64))


def k2_group_case(rng, record, ip, ix, plan, b, size, mode, odd, tdt,
                  alpha):
    """One batched K2 call of ``size`` members sharing b (values per
    member; c0 none, per member or shared by ``mode``; ``odd`` member
    strides) against its batched plain version; each member against its
    single launch, bit for bit where the two take one lane mapping.
    Returns (group launches, bit-checked members, whether the batch
    ends in a part-full group)."""
    from sparse_dot_tpu_torch.ops import csr

    npdt = NP_DTYPES[tdt]
    m, nnz, n = ip.numel() - 1, ix.numel(), b.shape[1]
    data = cuda(values(rng, (size, nnz), npdt))
    c0 = None if mode == 0 else cuda(values(
        rng, (size, m, n) if mode == 1 else (m, n), npdt))
    if odd:
        data = odd_members(data)
        c0 = odd_members(c0) if mode == 1 else c0
    al, be = (None, None) if mode == 0 else (alpha, 2.0)
    before = csr.csr_spmm.launches_group
    out = batched_call(csr.csr_spmm, 1, csr.spmm_batched, ip, ix, data, b,
                       al, be, c0, plan)
    grouped = csr.csr_spmm.launches_group - before
    if grouped != 2 * (size > 1):
        raise AssertionError(f"batched K2 of {size} members, b shared: "
                             f"{grouped} group launches in two calls")
    record("K2_csr_spmm", compare(
        out, csr.csr_spmm_batched_plain(ip, ix, data, b, al, be, c0), tdt))
    st0 = csr.member_stride("", c0, 2)
    batched = csr.spmm_schedule(n, tdt, nnz / m, csr.aligned_members(
        (b, 0), (c0, st0), (out, m * n)))
    group = csr.spmm_group(batched, tdt, ix.element_size(), size)
    part_full = csr.member_groups(size, group)[-1][1] < group
    bits = 0
    for i in range(size):
        c0_i = c0 if mode != 1 else c0[i]
        single = csr.spmm(ip, ix, data[i], b, al, be, c0_i, plan)
        aligned = all(t.data_ptr() % 16 == 0 for t in (b, single, c0_i)
                      if t is not None)
        if csr.spmm_schedule(n, tdt, nnz / m, aligned) == batched:
            if not same_bits(single, out[i]):
                raise AssertionError(f"batched K2 member {i} of {size}: "
                                     "bits differ from its single launch")
            bits += 1
        else:
            record("K2_csr_spmm", compare(out[i], single, tdt))
    return grouped, bits, part_full


def check_k2_groups(record):
    """Batched K2 with b shared and per-member values, which runs a group
    of ``csr.spmm_group`` members a block: every type of GROUP_TYPES, n in
    {1, 17, 64, 128} (a lane a row, scalar and 16-byte loads, a warp a
    row), a pattern with empty rows and one with a row past 3x the plan's
    chunk (split, each member's own counts and partial rows), batches of
    GROUP_SIZES, alpha / beta with c0 per member or shared, odd member
    strides; each call twice for the same bits, against the batched plain
    version, and each member against its single launch
    (``k2_group_case``).  Returns what was seen."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import csr

    rng = np.random.default_rng(SEED + 40)
    seen = {"group_launches": 0, "bit_checked_members": 0,
            "part_full_groups": 0, "groups": set()}
    for tdt, itype in GROUP_TYPES:
        npdt = NP_DTYPES[tdt]
        alpha = 0.5 - 0.25j if tdt.is_complex else -1.5
        for m, k, mean_row, empty_every, long_row in (
                (300, 200, 3, 5, 0), (257, 190, 12, 0, 3500)):
            indptr, indices, _ = random_csr(rng, m, k, mean_row, npdt, itype,
                                            empty_every, long_row)
            ip, ix = cuda(indptr), cuda(indices)
            plan = formats.csr_plan(ip, len(indices))
            if long_row and long_row < 3 * plan.chunk:
                raise AssertionError("K2 groups: the long row is too short")
            for n in (1, 17, 64, 128):
                b = cuda(values(rng, (k, n), npdt))
                for j, size in enumerate(GROUP_SIZES):
                    grouped, bits, part_full = k2_group_case(
                        rng, record, ip, ix, plan, b, size, j % 3,
                        size == 5, tdt, alpha)
                    seen["group_launches"] += grouped
                    seen["bit_checked_members"] += bits
                    seen["part_full_groups"] += part_full
                    s = csr.spmm_schedule(n, tdt, len(indices) / m)
                    seen["groups"].add((str(tdt), str(ix.dtype), size,
                                        s.lanes, csr.spmm_group(
                                            s, tdt, ix.element_size(),
                                            size)))
    if not seen["part_full_groups"]:
        raise AssertionError("K2 groups: no batch ended in a part-full "
                             "group")
    seen["groups"] = sorted(map(list, seen["groups"]))
    return seen


def check_k5_groups(record):
    """Batched K5 with a group of ``spgemm.fill_groups`` members a block
    in each bin: every type of GROUP_TYPES, SPGEMM_BATCH_CASES' first
    three (the sorted-product bins and hash tables of a block with the
    dense rows in the device workspace, a dense row in shared memory, the
    register bins), with and without ``triangular``, batches of
    K5_GROUP_RUNS (GROUP_SIZES at the wrapper's groups, and 5 members at
    most 2 a block: groups of 2, 2 and a part-full 1) with op(A)'s,
    op(B)'s or both values per member (and odd member strides at 5); each
    call twice for the same bits, against the batched plain version, its
    indices equal to the product's, and each member's values equal, bit
    for bit, to its single fill's.  Returns the (bin kind, members a
    block) seen."""
    from sparse_dot_tpu_torch.ops import spgemm

    rng = np.random.default_rng(SEED + 41)
    seen = set()
    bits = 0
    for tdt, itype in GROUP_TYPES:
        npdt = NP_DTYPES[tdt]
        for m, k, n, a_rows, b_rows in SPGEMM_BATCH_CASES[:3]:
            a = distinct_rows(rng, np.resize(a_rows, m), k, npdt, itype)
            b = distinct_rows(rng, np.resize(b_rows, k), n, npdt, itype)
            a_ip, a_ix, a_dv = map(cuda, a)
            b_ip, b_ix, b_dv = map(cuda, b)
            plan = spgemm.spgemm_plan(a_ip, a_ix, b_ip, n, tdt, a_ip.dtype)
            sizes = plan.offsets.diff().tolist()
            shapes = ((a[1].size,), (b[1].size,))
            for tri in (False, True):
                c_ip, c_ix, _ = spgemm.product(a_ip, a_ix, a_dv, b_ip, b_ix,
                                               b_dv, n, tri)
                nnz = c_ix.numel()
                for j, (size, most) in enumerate(K5_GROUP_RUNS):
                    combo = PAIR_COMBOS[j % 3]
                    av, bv = (cuda(values(rng, (size, *shape), npdt))
                              if batched else cuda(values(rng, shape, npdt))
                              for shape, batched in zip(shapes, combo))
                    if size == 5:
                        av, bv = (odd_members(x) if x.dim() == 2 else x
                                  for x in (av, bv))
                    groups = spgemm.fill_groups(plan.bins, tdt, a_ip.dtype,
                                                size, most)
                    live = [(int(kind), int(g)) for kind, g, rows in zip(
                        plan.bins[:, 0], groups, sizes) if rows]
                    launcher = spgemm._fill_launcher(
                        a_ip, a_ix, av, b_ip, b_ix, bv, n, plan, c_ip, tri,
                        size)
                    before = spgemm.csr_spgemm_fill.launches_group
                    idx, out = spgemm_batched_call(
                        spgemm.csr_spgemm_fill, int(nnz > 0), "K5",
                        (lambda: spgemm.fill_batched(
                            a_ip, a_ix, av, b_ip, b_ix, bv, n, plan, c_ip,
                            nnz, tri)) if most is None else
                        (lambda: launcher(nnz, sizes, most)))
                    grouped = spgemm.csr_spgemm_fill.launches_group - before
                    want = 2 * (nnz > 0 and max(g for _, g in live) > 1)
                    if grouped != want:
                        raise AssertionError(
                            f"batched K5 of {size}: {grouped} group "
                            f"launches in two calls, expected {want}")
                    ref = spgemm.csr_spgemm_fill_batched_plain(
                        a_ip, a_ix, av, b_ip, b_ix, bv, n, tri)
                    if not (torch.equal(idx, c_ix)
                            and torch.equal(idx, ref[0])):
                        raise AssertionError(f"batched K5 {tdt} m={m}: "
                                             "indices differ")
                    record("K5_csr_spgemm_fill", compare(out, ref[1], tdt))
                    for i in range(size if nnz else 0):
                        single = spgemm.csr_spgemm_fill(
                            a_ip, a_ix, av[i] if av.dim() == 2 else av,
                            b_ip, b_ix, bv[i] if bv.dim() == 2 else bv, n,
                            plan, c_ip, nnz, tri, bin_sizes=sizes)[1]
                        if not same_bits(single, out[i]):
                            raise AssertionError(
                                f"batched K5 {tdt} m={m} member {i} of "
                                f"{size}: bits differ from its single fill")
                        bits += 1
                    seen.update(live)
    kinds = {kind for kind, g in seen if g > 1}
    want = {spgemm.SORTED_WARP, spgemm.HASH_BLOCK, spgemm.DENSE_SHARED}
    if (not want <= kinds or not kinds & set(spgemm.TINY_KINDS.values())
            or (spgemm.DENSE_GLOBAL, 1) not in seen
            or not {(spgemm.SORTED_WARP, 2), (spgemm.SORTED_WARP, 4)}
            <= seen):
        raise AssertionError(f"K5 groups ran only {sorted(seen)}")
    return {"bins_and_members": sorted(map(list, seen)),
            "bit_checked_members": bits}


def k6_batched_at(args, group, alpha=None, beta=None, c0=None,
                  triangular=False):
    """K6's batched launch of ``args`` = (ip, ix, av, bip, bix, bv, n),
    op(B)'s rows sorted, the values (and ``c0``) with a member dimension
    ahead or shared, at ``group`` members a block (1: the per-member
    instance, as the parent ran every batch) on the single plan, as
    ``spgemm.spgemm_dense_batched`` makes it: for phase 2's group checks,
    phase 4's rows and ``compare_k7_k13.py``'s sweeps."""
    from sparse_dot_tpu_torch.ops import csr, spgemm

    ip, ix, av, bip, bix, bv, n = args
    m = ip.numel() - 1
    size = next(t.shape[0] for t, core in ((av, 1), (bv, 1), (c0, 2))
                if t is not None and t.dim() > core)
    strides = (csr.member_stride("", av, 1), csr.member_stride("", bv, 1),
               csr.member_stride("", c0, 2), m * n)
    c = torch.empty((size, m, n), dtype=av.dtype, device=av.device)
    spgemm._k6_launcher(ip, ix, av, bip, n, alpha, beta, c0 is not None,
                        triangular)(
        bix, size, strides, av.data_ptr(), bv.data_ptr(),
        None if c0 is None else c0.data_ptr(), c.data_ptr(), False, group)
    return c


# Phase 2's batched K6 groups: (m, k, n, op(A)'s row length, op(B)'s): a
# row a block of 8 warps (splits 8) in one window; rows cut into windows
# with the window-start table; windows without it (op(A) holds fewer
# entries than op(B) has rows).  The forms: which of op(A)'s values,
# op(B)'s values and c0 have the member dimension (K6_COMBOS' order).
K6_GROUP_CASES = ((40, 2000, 300, 600, 12), (60, 300, 1000, 20, 60),
                  (12, 400, 1000, 5, 40))
K6_GROUP_SIZES = (2, 3, 5)


def check_k6_groups(record):
    """Batched K6 at 2 and 4 members a block (``k6_batched_at``; 4 in the
    ONE_SUM form) in every
    value type and both index widths, in the four forms of K6_COMBOS (op(A)'s
    values per member; both; op(B)'s; only c0), each case of
    K6_GROUP_CASES with and without ``triangular``, batches of
    K6_GROUP_SIZES (3 and 5: a part-full last group), alpha / beta with
    c0 shared or per member; each call against the batched plain version
    and run twice for the same bits, each member bit for bit against its
    single launch (the group runs on the single plan), and the wrapper's
    call (its group launch counted) against
    the forced one.  Returns what was seen."""
    from sparse_dot_tpu_torch.ops import spgemm

    rng = np.random.default_rng(SEED + 43)
    seen = {"groups": set(), "plans": set(), "bit_checked_members": 0,
            "part_full_groups": 0}
    for tdt, npdt in NP_DTYPES.items():
        alpha = 0.5 - 0.25j if tdt.is_complex else -1.5
        for itype in (np.int32, np.int64):
            for m, k, n, a_rows, b_rows in K6_GROUP_CASES:
                a = distinct_rows(rng, np.resize(a_rows, m), k, npdt, itype)
                b = sorted_rows(*distinct_rows(rng, np.resize(b_rows, k), n,
                                               npdt, itype))
                ip, ix, dv = map(cuda, a)
                bip, bix, bdv = map(cuda, b)
                for j, size in enumerate(K6_GROUP_SIZES):
                    for a_b, b_b, c_b in K6_COMBOS:
                        tri = bool((j + a_b) % 2)
                        av = (cuda(values(rng, (size, dv.numel()), npdt, 0.3))
                              if a_b else dv)
                        bv = (cuda(values(rng, (size, bdv.numel()), npdt,
                                          0.3)) if b_b else bdv)
                        c0 = None if c_b is None else cuda(values(
                            rng, (size, m, n) if c_b == "batched" else (m, n),
                            npdt))
                        al, be = (None, None) if c0 is None else (alpha, 2.0)
                        args = (ip, ix, av, bip, bix, bv, n)
                        want = spgemm.csr_spgemm_dense_batched_plain(
                            *args, al, be, c0, tri)
                        form = spgemm.dense_form(a_b, b_b)
                        groups = ((4,) if form == spgemm.ONE_SUM else
                                  (2,) if size == 2 else (2, 4))
                        for group in groups:
                            out = k6_batched_at(args, group, al, be, c0, tri)
                            if not same_bits(out, k6_batched_at(
                                    args, group, al, be, c0, tri)):
                                raise AssertionError("batched K6 group: runs "
                                                     "differ")
                            record("K6_csr_spgemm_dense",
                                   compare(out, want, tdt))
                            gplan = spgemm.csr_spgemm_dense.last_plan
                            seen["groups"].add((form, group))
                            seen["plans"].add((gplan.splits > 1,
                                               gplan.windows > 1, tri))
                            seen["part_full_groups"] += size % group > 0
                            for i in range(size):
                                single_args = (
                                    ip, ix, av[i] if a_b else av, bip, bix,
                                    bv[i] if b_b else bv, n)
                                c0_i = c0[i] if c_b == "batched" else c0
                                single = spgemm.csr_spgemm_dense(
                                    *single_args, al, be, c0_i, tri,
                                    b_sorted=True)
                                if (spgemm.csr_spgemm_dense.last_plan != gplan
                                        or not same_bits(single, out[i])):
                                    raise AssertionError(
                                        f"batched K6 {tdt} {form} member "
                                        f"{i} of {size} at {group} a block: "
                                        "plan or bits differ from its "
                                        "single launch")
                                seen["bit_checked_members"] += 1
                        before = spgemm.csr_spgemm_dense.launches_group
                        got = spgemm.spgemm_dense_batched(
                            *args, al, be, c0, tri, b_sorted=True)
                        grouped = (spgemm.csr_spgemm_dense.launches_group
                                   - before)
                        wanted = spgemm.dense_group(tdt, ix.element_size(),
                                                    size, form)
                        if grouped != (wanted > 1):
                            raise AssertionError(
                                f"batched K6 of {size}: {grouped} group "
                                f"launches, expected {wanted} a block")
                        if not same_bits(got, k6_batched_at(
                                args, wanted, al, be, c0, tri)):
                            raise AssertionError("batched K6: the wrapper's "
                                                 "bits differ")
    want = {(f, g) for f in (spgemm.B_SHARED, spgemm.B_PER_MEMBER)
            for g in (2, 4)} | {(spgemm.ONE_SUM, 4)}
    if (not want <= seen["groups"] or not seen["part_full_groups"]
            or {(True, False), (False, True)} - {p[:2] for p in
                                                  seen["plans"]}):
        raise AssertionError(f"K6 groups ran only {seen}")
    return {key: sorted(map(list, v)) if isinstance(v, set) else v
            for key, v in seen.items()}


def k1_batched_at(ip, ix, data, b, plan, group, alpha=None, beta=None,
                  c0=None):
    """K1's batched launch of ``data``'s members ((B, nblocks, bs, bs)), b
    shared, on the tensor cores at ``group`` members a block (1: the
    per-member instance, as the parent ran every batch), as ``bsr.spmm_batched`` makes it
    (``bsr._launch_k1``): for phase 2's group checks, phase 4's rows and
    ``compare_k7_k13.py``'s sweeps."""
    from sparse_dot_tpu_torch.ops import bsr, csr

    size, _, bs, _ = data.shape
    m, n = (ip.numel() - 1) * bs, b.shape[-1]
    c = torch.empty((size, m, n), dtype=b.dtype, device=b.device)
    bsr._launch_k1(ip, ix, plan, alpha, beta, c0 is not None, size,
                   (data.stride(0), 0, csr.member_stride("", c0, 2), m * n),
                   data.data_ptr(), b.data_ptr(),
                   None if c0 is None else c0.data_ptr(), c.data_ptr(), data,
                   b, group)
    return c


def check_k1_groups(record):
    """Batched K1 on the tensor cores with b shared and per-member blocks,
    f32 and f64, int32 and int64 ids: bs 8, 16, 32, 64 and 128 (two
    64-row tiles), a split block row (each member's
    own workspace slots), n in {37, 64} (element and 16-byte copies),
    batches of 2, 3 and 5 at 2 and 4 members a block
    (``k1_batched_at``), alpha / beta with c0 none, shared or per member
    and odd member strides at 5; each call against the batched plain
    version and run twice for the same bits, each member bit for bit
    against its single launch, and the wrapper's call against the forced
    one (its group launch counted).  Returns what was seen."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr

    rng = np.random.default_rng(SEED + 44)
    seen = {"groups": set(), "bit_checked_members": 0}
    for tdt in (torch.float32, torch.float64):
        npdt = NP_DTYPES[tdt]
        for itype in (np.int32, np.int64):
            for bs in (8, 16, 32, 64, 128):
                nbrows = max(6, 384 // bs)
                indptr, indices, _ = random_bsr(rng, nbrows, nbrows, bs, 2,
                                                npdt, itype, 5, True)
                ip, ix = cuda(indptr), cuda(indices)
                plan = formats.bsr_chunk_plan(ip, len(indices))
                if not plan.splits.shape[0]:
                    raise AssertionError("K1 groups: no split block row")
                for j, (n, size) in enumerate(((37, 2), (64, 3), (37, 5),
                                               (64, 5))):
                    data = cuda(values(rng, (size, len(indices), bs, bs),
                                       npdt, 1.0 / np.sqrt(2 * bs)))
                    if size == 5:
                        data = odd_members(data)
                    b = cuda(values(rng, (nbrows * bs, n), npdt))
                    mode = (j + bs) % 3
                    c0 = None if mode == 0 else cuda(values(
                        rng, (size, nbrows * bs, n) if mode == 2
                        else (nbrows * bs, n), npdt))
                    al, be = (None, None) if c0 is None else (-1.5, 2.0)
                    want = bsr.bsr_spmm_batched_plain(ip, ix, data, b, al,
                                                      be, c0)
                    for group in ((2,) if size == 2 else (2, 4)):
                        out = k1_batched_at(ip, ix, data, b, plan, group,
                                            al, be, c0)
                        if not same_bits(out, k1_batched_at(
                                ip, ix, data, b, plan, group, al, be, c0)):
                            raise AssertionError("batched K1 group: runs "
                                                 "differ")
                        record("K1_bsr_spmm_tc", compare(out, want, tdt))
                        seen["groups"].add((str(tdt), bs, group))
                        for i in range(size):
                            c0_i = c0[i] if mode == 2 else c0
                            single = bsr.spmm(ip, ix, data[i], b, al, be,
                                              c0_i, plan)
                            if not same_bits(single, out[i]):
                                raise AssertionError(
                                    f"batched K1 {tdt} bs {bs} member {i} "
                                    f"of {size} at {group} a block: bits "
                                    "differ from its single launch")
                            seen["bit_checked_members"] += 1
                    before = bsr.bsr_spmm.launches_group
                    got = bsr.spmm_batched(ip, ix, data, b, al, be, c0, plan)
                    group = bsr.spmm_group(tdt, bs, size)
                    if bsr.bsr_spmm.launches_group - before != (group > 1):
                        raise AssertionError(f"batched K1 of {size}: group "
                                             "launches")
                    if not same_bits(got, k1_batched_at(
                            ip, ix, data, b, plan, group, al, be, c0)):
                        raise AssertionError("batched K1: the wrapper's bits "
                                             "differ")
    return {"groups": sorted(map(list, seen["groups"])),
            "bit_checked_members": seen["bit_checked_members"]}


def check_groups(record):
    """Phase 2's member groups of batched K2, K5, K6 and K1
    (``check_k2_groups``, ``check_k5_groups``, ``check_k6_groups``,
    ``check_k1_groups``)."""
    return {"K2": check_k2_groups(record), "K5": check_k5_groups(record),
            "K6": check_k6_groups(record), "K1": check_k1_groups(record)}


def check_second_order():
    """``torch.autograd.gradgradcheck`` (with forward over reverse) on the
    card in f64 and c128, with the plain versions refused, of
    ``ops.coo_spmm_raw``, ``coo_spmv``, ``csr.csr_spmm`` and
    ``csr.csr_spmv`` (9 x 7 with a repeated entry, alpha and beta); of
    ``ops.bsr_spmm`` in the blocks, b and c0 (alpha and beta, a repeated
    block and negative block ids) at bs 8 in f64 (K1's and K8's
    tensor-core variants) and at bs 3 in c128 (their CUDA-core ones), and
    at bs 8 in c128 on one block stored twice (once by negative ids) and
    n = 1 (the tensor cores' complex instances); of
    ``csr_spgemm_dense`` in both operands' values (alpha, 6 x 9 by 9 x 7)
    over sorted op(B), with c0 and beta, and with ``triangular``, and
    with ``b_sorted=False`` over the same op(B) shuffled; and of
    ``csr_spgemm``'s values with and without ``triangular``: K1 and K8
    (both variants each), K2-K7, K9 and K11 must launch.  Returns the
    launches."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, csr, spgemm

    rng = np.random.default_rng(SEED + 17)
    m, k = 9, 7
    rows = np.array([0, 0, 1, 3, 3, 4, 5, 5, 6, 7, 8, 8, 1], np.int32)
    cols = np.array([1, 4, 0, 2, 6, 3, 0, 5, 4, 1, 2, 6, 0], np.int32)
    a = sps.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, k))
    tr, tc, ip, ix = map(cuda, (rows, cols, a.indptr.astype(np.int32),
                                a.indices.astype(np.int32)))
    block_rows = cuda(np.array([0, 2, 2, -1, 0, 1], np.int32))
    block_cols = cuda(np.array([1, 0, 0, 1, -2, 1], np.int32))
    # One block twice, the second time by negative ids.
    few_rows = cuda(np.array([0, -3], np.int32))
    few_cols = cuda(np.array([1, -1], np.int32))
    # op(B)'s rows shuffled (``b_sorted=False``) and sorted.
    a_ip, a_ix, _ = map(cuda, distinct_rows(rng, (3, 0, 2, 5, 1, 4), 9,
                                            np.float64, np.int32))
    b_arrays = distinct_rows(rng, (2, 4, 0, 3, 1, 2, 5, 0, 3), 7,
                             np.float64, np.int32)
    b_ip, b_shuffled, _ = map(cuda, b_arrays)
    b_sorted = cuda(sorted_rows(*b_arrays)[1])
    before = read_launches()
    with plain_versions_refused():
        for npdt in (np.float64, np.complex128):
            def leaf(shape):
                return cuda(values(rng, shape, npdt)).requires_grad_()

            complex_ = np.dtype(npdt).kind == "c"
            alpha = 2.0 - 0.5j if complex_ else 2.0
            beta = 0.25 + 1j if complex_ else -0.5
            checks = [
                (lambda v, b: autograd.coo_spmm_raw(tr, tc, v, b, m),
                 (leaf(len(rows)), leaf((k, 2)))),
                (lambda v, x, y: autograd.coo_spmv(tr, tc, v, x, m, -1.5,
                                                   0.5, y),
                 (leaf(len(rows)), leaf(k), leaf(m))),
                (lambda v, b, c: csr.csr_spmm(ip, ix, v, b, alpha, -1.0, c),
                 (leaf(a.nnz), leaf((k, 2)), leaf((m, 2)))),
                (lambda v, x, y: csr.csr_spmv(ip, ix, v, x, alpha, -1.0, y),
                 (leaf(a.nnz), leaf(k), leaf(m)))]
            bs = 3 if complex_ else 8
            checks.append((
                lambda dd, bb, cc: ops.bsr_spmm(
                    dd, block_rows, block_cols, bb, 3 * bs, alpha, beta, cc),
                (leaf((6, bs, bs)), leaf((2 * bs, 2)), leaf((3 * bs, 2)))))
            if complex_:  # the complex tensor-core instances, 2 blocks
                checks.append((
                    lambda dd, bb, cc: ops.bsr_spmm(
                        dd, few_rows, few_cols, bb, 24, alpha, beta, cc),
                    (leaf((2, 8, 8)), leaf((16, 1)), leaf((24, 1)))))
            checks.append((
                lambda av, bv, cc: spgemm.csr_spgemm_dense(
                    a_ip, a_ix, av, b_ip, b_sorted, bv, 7, alpha, beta, cc,
                    b_sorted=True),
                (leaf(a_ix.numel()), leaf(b_ip[-1].item()), leaf((6, 7)))))
            # c0's second derivative is 0: one check above holds it.
            for tri, b_ix, warrant in ((True, b_sorted, True),
                                       (False, b_shuffled, False)):
                checks.append((
                    lambda av, bv, tri=tri, b_ix=b_ix, warrant=warrant:
                    spgemm.csr_spgemm_dense(a_ip, a_ix, av, b_ip, b_ix, bv,
                                            7, alpha, triangular=tri,
                                            b_sorted=warrant),
                    (leaf(a_ix.numel()), leaf(b_ip[-1].item()))))
            for tri in (False, True):
                checks.append((
                    lambda av, bv, tri=tri: spgemm.csr_spgemm(
                        a_ip, a_ix, av, b_ip, b_sorted, bv, 7, tri)[2],
                    (leaf(a_ix.numel()), leaf(b_ip[-1].item()))))
            for fn, inputs in checks:
                if not torch.autograd.gradgradcheck(fn, inputs,
                                                    check_fwd_over_rev=True):
                    raise AssertionError(f"gradgradcheck failed in {npdt}")
    launched = {name: count - before[name]
                for name, count in read_launches().items()}
    # K12 (and its indicator) and K13 have no gradient to check: every
    # other kernel must have moved.
    if not all(count for name, count in launched.items() if name not in (
            "K12_csr_densify", "K12_csr_indicator", "K13_csr_compact")):
        raise AssertionError(f"gradgradcheck launched {launched}")
    return {name: count for name, count in launched.items() if count}


def check_gradcheck():
    """``torch.autograd.gradcheck`` of ``coo_spmm_raw`` (values and b),
    ``coo_spmv`` (values, x and y0, with alpha and beta) and ``csr_spmm``
    (values, b and c0) on the card in f64 and c128, 60 x 50 at n = 5; of
    the BSR device function ``ops.bsr_spmm`` (blocks, b and c0, with a
    repeated block and negative block ids) at bs = 8 (on K1's and K8's
    tensor cores, c128 on their complex instances) and bs = 3; and of
    ``csr_spgemm_dense`` (both operands' values and c0, 6 x 9 by 9 x 7,
    rows of distinct shuffled columns) with and without
    ``triangular``; reverse and forward mode (``check_forward_ad``), with
    the plain versions refused: K1 and K8 (both variants each), K2, K3,
    K6, K7 and K9 must each launch.  Returns the launches."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, csr, spgemm

    rng = np.random.default_rng(SEED + 7)
    m, k, n = 60, 50, 5
    indptr, indices, _ = random_csr(rng, m, k, 4, np.float64, np.int32, 7)
    rows = cuda(np.repeat(np.arange(m), np.diff(indptr)).astype(np.int32))
    ip, ix = cuda(indptr), cuda(indices)
    block_rows = cuda(np.array([0, 2, 2, -1, 0, 1], np.int32))
    block_cols = cuda(np.array([1, 0, 0, 1, -2, 1], np.int32))
    # Rows of distinct, shuffled columns: K6 takes op(B) without repeats.
    a_ip, a_ix, _ = distinct_rows(rng, (3, 0, 2, 5, 1, 4), 9, np.float64,
                                  np.int32)
    b_ip, b_ix, _ = distinct_rows(rng, (2, 4, 0, 3, 1, 2, 5, 0, 3), 7,
                                  np.float64, np.int32)
    a_ip, a_ix, b_ip, b_ix = map(cuda, (a_ip, a_ix, b_ip, b_ix))
    before = read_launches()
    with plain_versions_refused():
        for tdt, npdt in ((torch.float64, np.float64),
                          (torch.complex128, np.complex128)):
            def leaf(shape):
                return cuda(values(rng, shape, npdt)).requires_grad_()

            v, b, x, y0, c0 = (leaf(len(indices)), leaf((k, n)), leaf(k),
                               leaf(m), leaf((m, n)))
            checks = [
                (lambda vv, bb: autograd.coo_spmm_raw(rows, ix, vv, bb, m),
                 (v, b)),
                (lambda vv, xx, yy: autograd.coo_spmv(rows, ix, vv, xx, m,
                                                      -1.5, 0.5, yy),
                 (v, x, y0)),
                (lambda vv, bb, cc: csr.csr_spmm(ip, ix, vv, bb, 2.0, -1.0,
                                                 cc), (v, b, c0)),
            ]
            for bs in (8, 3):
                checks.append((
                    lambda dd, bb, cc, bs=bs: ops.bsr_spmm(
                        dd, block_rows, block_cols, bb, 3 * bs, 1.5, -0.5,
                        cc),
                    (leaf((6, bs, bs)), leaf((2 * bs, 3)),
                     leaf((3 * bs, 3)))))
            for tri in (False, True):
                checks.append((
                    lambda av, bv, cc, tri=tri: spgemm.csr_spgemm_dense(
                        a_ip, a_ix, av, b_ip, b_ix, bv, 7, 2.0, -0.5, cc,
                        tri),
                    (leaf(a_ix.numel()), leaf(b_ix.numel()), leaf((6, 7)))))
            for fn, inputs in checks:
                if not torch.autograd.gradcheck(fn, inputs,
                                                check_forward_ad=True):
                    raise AssertionError(f"gradcheck failed in {tdt}")
    launched = {name: count - before[name]
                for name, count in read_launches().items()}
    if not all(launched[name] > 0 for name in (
            "K1_bsr_spmm_tc", "K1_bsr_spmm_tc_complex", "K1_bsr_spmm_simt",
            "K2_csr_spmm", "K3_csr_spmv", "K6_csr_spgemm_dense",
            "K7_csr_sddmm", "K8_bsr_sddmm_tc", "K8_bsr_sddmm_tc_complex",
            "K8_bsr_sddmm_simt",
            "K9_csr_spgemm_sddmm")):
        raise AssertionError(f"gradcheck launched {launched}")
    return {name: count for name, count in launched.items() if count}


# The names of K4's and K5's row kernels in a profiler trace.
K45_KERNELS = ("spgemm_tiny_kernel", "spgemm_sorted_kernel",
               "spgemm_rows_kernel")
# K4/K5/K6 cases: (m rows of op(A), k, n, entries of the rows of op(A) in
# turn, entries of the rows of op(B) in turn, small integer values, the
# lowest column of op(B)).  In the first four, rows of op(A) take 0, 1,
# 3, 10, 40, 150 and 600 entries, so with 20 per row of op(B) their
# products are 0, 20, 60, 200, 800, 3000 and 12000: at n = 100,000 that
# puts rows in the register bin of 32 lanes, both sorted-product bins,
# both hash bins of a block and, past the largest table, the device
# workspace; at n = 5000 in the register bin, the sorted-product bin of
# 128 and the dense row in shared memory; at n = 300 in the register bin
# and the dense row.  The next three put rows of 1..32 products in every
# register bin (ops/spgemm.py, spgemm_bins) at n = 1, 8 and 16: long runs
# of one column, rows with more products than n, and (n = 1) values in
# {-1, 0, 1, 2}, whose sums are exact and often cancel to a stored 0.  The
# eighth has op(A) rows of up to 100 entries, longer than any group, over
# mostly empty op(B) rows, so the groups walk them in chunks.  The next
# two hold op(B)'s columns in the top 64 below n = 2^27 and 2^27 - 1, with
# rows of 1..32 products: the register bins sort 64-bit keys at the first
# n and 32-bit keys, whose column bits are then full, at the second
# (csrc/csr_spgemm.cuh, kNarrowKeyColumns).  The next nine give the
# sorted-product bins rows of exactly 33, 128, 129 and 512 products (op(B)
# rows of 1, 3 and 4 entries; 512 op(A) entries walked 32 at a time) at n
# = 100,000 and with op(B)'s columns in the top 4096 below n = 2^23 and
# 2^23 - 1, where their keys are of 64 bits and of 32 bits with the
# column bits full (kSortedNarrowColumns); then rows of 40-600 products
# over op(B) rows that share 16 columns, so that one column's run spans
# several registers of 32 sorted keys (small integer values).  The last
# three give K6 (ops/spgemm.py, dense_plan) rows split across warps (one
# row of 2000 entries; three of 1200-2000 over n = 5000, so in windows
# too) and 6000 short rows, a warp each.  K6 runs where its dense output
# holds at most K6_MAX_ENTRIES, over op(B) with its rows sorted and
# shuffled (which the wrapper sorts first where the plan searches them).
SPGEMM_A_ROWS = (0, 1, 3, 10, 40, 150, 600)
WIDE_KEY_N = 1 << 27
SORTED_KEY_N = 1 << 23
# The bins a case whose n is at a key width's edge keeps its rows in.
KEY_EDGE_BINS = {WIDE_KEY_N: "register", WIDE_KEY_N - 1: "register",
                 SORTED_KEY_N: "sorted", SORTED_KEY_N - 1: "sorted"}
K6_MAX_ENTRIES = 1 << 24
SPGEMM_CASES = (
    (42, 2000, 100_000, SPGEMM_A_ROWS, (20,), False, 0),
    (42, 2000, 5000, SPGEMM_A_ROWS, (20,), False, 0),
    (42, 2000, 300, SPGEMM_A_ROWS, (20,), False, 0),
    (30, 50, 60, SPGEMM_A_ROWS, (0,), False, 0),
    (70, 200, 1, (1, 2, 3, 4, 5, 7, 8, 9, 13, 16, 17, 25, 31, 32), (1,),
     True, 0),
    (70, 300, 8, (1, 2, 3, 5, 8, 0, 12), (0, 1, 2, 3, 4, 6, 8), False, 0),
    (70, 300, 16, (1, 2, 4, 6, 9), (1, 2, 3, 5, 8), False, 0),
    (48, 3000, 100_000, (100, 40, 64, 3, 97), (0,) * 29 + (1, 2), False,
     0),
    (48, 300, WIDE_KEY_N, (1, 2, 3, 5, 8, 0), (0, 1, 2, 4), False,
     WIDE_KEY_N - 64),
    (48, 300, WIDE_KEY_N - 1, (1, 2, 3, 5, 8, 0), (0, 1, 2, 4), False,
     WIDE_KEY_N - 65),
    *((8, 600, n, a_rows, b_rows, False, low)
      for n, low in ((100_000, 0), (SORTED_KEY_N, SORTED_KEY_N - 4096),
                     (SORTED_KEY_N - 1, SORTED_KEY_N - 4097))
      for a_rows, b_rows in (((33, 128, 129, 512), (1,)),
                             ((11, 43), (3,)), ((32, 128), (4,)))),
    (8, 600, 100_000, (10, 40, 100, 120), (4, 3, 5), True, 100_000 - 16),
    (1, 3000, 300, (2000,), (20,), False, 0),
    (3, 3000, 5000, (1200, 2000, 1500), (20,), False, 0),
    (6000, 400, 48, (2, 3, 5, 0), (3, 6), False, 0),
)
# What each K6 launch of phase 2 is known by: its row split across warps,
# cut into windows, op(B) sorted, triangular, op(B)'s window starts
# tabulated.  Every combination of the first three must run, triangular
# over sorted and shuffled op(B), and sorted windows with and without the
# table.
K6_PLAN_KEYS = ("split", "windows", "sorted", "triangular", "table")


def distinct_rows(rng, lengths, width, dtype, index_dtype, zeros=0.0,
                  exact=False, low=0):
    """CSR arrays whose rows hold ``lengths`` distinct, shuffled columns
    in [low, width); a share ``zeros`` of the values are explicit 0; with
    ``exact`` the values are drawn from {-1, 0, 1, 2}."""
    cols = [low + rng.choice(width - low, size=min(int(n), width - low),
                             replace=False)
            for n in lengths]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    indices = (np.concatenate(cols) if cols else np.zeros(0)).astype(
        index_dtype)
    if exact:
        data = rng.choice([-1.0, 0.0, 1.0, 2.0], len(indices)).astype(dtype)
    else:
        data = values(rng, len(indices), dtype, 0.3)
    data[rng.random(len(data)) < zeros] = 0
    return indptr.astype(index_dtype), indices, data


class no_host_sync:
    """Inside the block, an operation that waits for the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return False


def spgemm_call(plan_fn, *args, on_card=False):
    """The plan, K4, the running sum and K5 through their wrappers, each
    kernel checked to launch once and all but the nnz read checked not to
    wait for the card: (plan, counts, indptr, indices, data).  With
    ``on_card`` K4 builds the plan in its launch (``plan_and_count``, as
    ``csr_spgemm`` runs it) and K5 is given the bin sizes, read with nnz;
    else the plan is ``plan_fn()``'s and K5 reads the bin sizes itself."""
    from sparse_dot_tpu_torch.ops import spgemm

    a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, n, tri = args
    before = (spgemm.csr_spgemm_count.launches,
              spgemm.csr_spgemm_fill.launches)
    with no_host_sync():
        if on_card:
            plan, counts = spgemm.plan_and_count(a_ip, a_ix, b_ip, b_ix, n,
                                                 a_dv.dtype, tri)
        else:
            plan = plan_fn()
            counts = spgemm.csr_spgemm_count(a_ip, a_ix, b_ip, b_ix, n,
                                             plan, tri)
        indptr = torch.zeros(len(counts) + 1, dtype=torch.long,
                             device="cuda")
        torch.cumsum(counts, 0, out=indptr[1:])
    nnz = int(indptr[-1])
    indptr = indptr.to(a_ip.dtype)
    sizes = plan.offsets.diff().tolist() if on_card else None
    indices, data = spgemm.csr_spgemm_fill(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv,
                                           n, plan, indptr, nnz, tri, sizes)
    launched = (spgemm.csr_spgemm_count.launches - before[0],
                spgemm.csr_spgemm_fill.launches - before[1])
    if launched != (1, int(nnz > 0)):
        raise AssertionError(f"K4/K5 launched {launched} times")
    return plan, counts, indptr, indices, data


def check_bins_seen(bins_seen):
    """Every kind of K4/K5 row bin held rows in some phase-2 case."""
    from sparse_dot_tpu_torch.ops import spgemm

    wanted = {*spgemm.TINY_KINDS.values(), spgemm.SORTED_WARP,
              spgemm.HASH_BLOCK, spgemm.DENSE_SHARED, spgemm.DENSE_GLOBAL}
    if bins_seen != wanted:
        raise AssertionError(f"K4/K5 bins exercised {bins_seen}, want "
                             f"{wanted}")


def check_k6_seen(k6_seen):
    """K6 ran every launch plan of phase 2's kind (``K6_PLAN_KEYS``)."""
    plans = {seen[:3] for seen in k6_seen}
    tri = {seen[2] for seen in k6_seen if seen[3]}
    table = {seen[4] for seen in k6_seen if seen[1] and seen[2]}
    wanted = {(a, b, c) for a in (False, True) for b in (False, True)
              for c in (False, True)}
    if plans != wanted or tri != {False, True} or table != {False, True}:
        raise AssertionError(f"K6 ran {sorted(k6_seen)} {K6_PLAN_KEYS}")


def sorted_rows(indptr, indices, data):
    """The CSR arrays with each row's columns in ascending order."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    order = np.lexsort((indices, rows))
    return indptr, indices[order], data[order]


def check_spgemm(rng, tdt, npdt, itype, record, bins_seen, k6_seen):
    """K4 + K5 against the plain ESC (``spgemm_plain``): counts, indptr and
    indices equal, values within tolerance, the same bits on a second
    run; K6 against its plain version, with and without the epilogue and
    ``triangular``, over op(B) sorted and shuffled, twice each.
    ``bins_seen`` collects the bin kinds that held rows, ``k6_seen`` K6's
    plans (``K6_PLAN_KEYS``)."""
    from sparse_dot_tpu_torch.ops import spgemm

    for m, k, n, a_rows, b_rows, exact, b_low in SPGEMM_CASES:
        a_len = [a_rows[i % len(a_rows)] for i in range(m)]
        b_len = [b_rows[i % len(b_rows)] for i in range(k)]
        a = distinct_rows(rng, a_len, k, npdt, itype, 0.05, exact)
        b = distinct_rows(rng, b_len, n, npdt, itype, 0.05, exact, b_low)
        a_ip, a_ix, a_dv = map(cuda, a)
        b_ip, b_ix, b_dv = map(cuda, b)

        def plan():
            return spgemm.spgemm_plan(a_ip, a_ix, b_ip, n, tdt, a_ip.dtype)

        p = plan()
        sizes = p.offsets.diff().cpu().numpy()
        held = {int(kind) for kind, size in zip(p.bins[:, 0], sizes)
                if size and kind != spgemm.SKIP}
        edge = KEY_EDGE_BINS.get(n)
        if edge and not held <= ({spgemm.SORTED_WARP} if edge == "sorted"
                                 else set(spgemm.TINY_KINDS.values())):
            raise AssertionError(f"K4/K5 n={n}: rows past the {edge} bins")
        bins_seen.update(held)
        for tri in (False, True):
            args = (a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, n, tri)
            _, counts, indptr, indices, data = spgemm_call(plan, *args)
            ref = spgemm.spgemm_plain(*args)
            torch.cuda.synchronize()
            if not (torch.equal(counts, ref[0].long().diff())
                    and torch.equal(indptr, ref[0])
                    and torch.equal(indices, ref[1])):
                raise AssertionError(f"K4/K5 {tdt} n={n}: pattern differs")
            err = compare(data, ref[2], tdt)
            record("K4_csr_spgemm_count", 0.0)
            record("K5_csr_spgemm_fill", err)
            again = spgemm_call(plan, *args, on_card=True)
            if not all(torch.equal(x, y) for x, y in
                       zip(again[0][:3], p[:3])):
                raise AssertionError(f"K4 {tdt} n={n}: the plan built on "
                                     f"the card differs from spgemm_plan's")
            if not all(torch.equal(x, y) for x, y in
                       zip(again[1:], (counts, indptr, indices, data))):
                raise AssertionError(f"K4/K5 {tdt} n={n}: runs differ")
            if m * n > K6_MAX_ENTRIES:
                continue
            c0 = cuda(values(rng, (m, n), npdt))
            b_sorted = tuple(map(cuda, sorted_rows(*b)))
            for srt, (bip, bix, bdv) in ((False, (b_ip, b_ix, b_dv)),
                                         (True, b_sorted)):
                for alpha, beta, cc in ((None, None, None),
                                        (2.0, -0.5, c0)):
                    kargs = (a_ip, a_ix, a_dv, bip, bix, bdv, n, alpha,
                             beta, cc, tri)
                    before = spgemm.csr_spgemm_dense.launches
                    out = spgemm.csr_spgemm_dense(*kargs, b_sorted=srt)
                    if spgemm.csr_spgemm_dense.launches != before + 1:
                        raise AssertionError("K6 did not launch once")
                    used = spgemm.csr_spgemm_dense.last_plan
                    k6_seen.add((used.splits > 1, used.windows > 1, srt,
                                 tri, spgemm.csr_spgemm_dense.last_table))
                    record("K6_csr_spgemm_dense", compare(
                        out, spgemm.csr_spgemm_dense_plain(*kargs), tdt))
                    if not torch.equal(out, spgemm.csr_spgemm_dense(
                            *kargs, b_sorted=srt)):
                        raise AssertionError(f"K6 {tdt} n={n} {used}: runs "
                                             f"differ")
            if tdt == torch.float64 and (used.windows > 1 or tri):
                check_k6_wrong_flag(a_ip, a_ix, b_ip, b_ix, n, tri)


def check_k6_repeats():
    """K6 on an op(B) whose rows repeat a column, the failing input of
    ROADMAP Queue 3's fault 1 (``random_csr(rng, 9, 7, 3, ...)`` as op(B),
    with ``b_sorted=False``): on the CPU and on the card, raw and tracked,
    ``csr_spgemm_dense`` raises the same ``ValueError`` and launches
    nothing.  Returns the message."""
    from sparse_dot_tpu_torch.ops import spgemm

    rng = np.random.default_rng(SEED + 13)
    b_ip, b_ix, b_dv = random_csr(rng, 9, 7, 3, np.float64)
    rows = np.repeat(np.arange(9), np.diff(b_ip))
    if len(set(zip(rows.tolist(), b_ix.tolist()))) == len(b_ix):
        raise AssertionError("op(B) repeats no column")
    a_ip, a_ix, a_dv = distinct_rows(rng, (3, 0, 2, 5, 1, 4), 9,
                                     np.float64, np.int32)
    messages = set()
    for device in ("cpu", "cuda"):
        for tracked in (False, True):
            args = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                    for x in (a_ip, a_ix, a_dv, b_ip, b_ix, b_dv)]
            args[2].requires_grad_(tracked)
            before = spgemm.csr_spgemm_dense.launches
            try:
                spgemm.csr_spgemm_dense(*args, 7)
            except ValueError as err:
                messages.add(str(err))
            else:
                raise AssertionError(f"K6 on {device} (tracked={tracked}) "
                                     "took a repeated column")
            if spgemm.csr_spgemm_dense.launches != before:
                raise AssertionError("K6 launched on a repeated column")
    if len(messages) != 1:
        raise AssertionError(f"K6's messages differ: {sorted(messages)}")
    return messages.pop()


def check_k6_wrong_flag(a_ip, a_ix, b_ip, b_ix, n, triangular):
    """K6 told that op(B)'s shuffled rows are sorted: each row is then
    searched as if it were, so products go missing, but each product's
    column is still tested against the work item's, so none may land
    elsewhere.  With every value 1 an entry of C counts its products:
    the kernel's count may fall short of the plain version's, never pass
    it (a write outside the warp's partial row would land in another
    column's count, or fault)."""
    from sparse_dot_tpu_torch.ops import spgemm

    ones_a = torch.ones(a_ix.numel(), dtype=torch.float64,
                        device=a_ix.device)
    ones_b = torch.ones(b_ix.numel(), dtype=torch.float64,
                        device=b_ix.device)
    args = (a_ip, a_ix, ones_a, b_ip, b_ix, ones_b, n)
    got = spgemm.csr_spgemm_dense(*args, triangular=triangular,
                                  b_sorted=True)
    want = spgemm.csr_spgemm_dense_plain(*args, triangular=triangular)
    if not bool((got <= want).all()):
        raise AssertionError(f"K6 n={n} triangular={triangular}: told "
                             f"shuffled rows were sorted, it wrote outside "
                             f"the work item's columns")


# ---------------------------------------------------------------------------
# Phase 3: the main path through dot_product at real sizes
# ---------------------------------------------------------------------------


def config1_csr(rng, size, dtype=np.float64, density=0.01):
    """BASELINE config 1: CSR, 10,000 x 10,000 at 1% density; values
    N(0, 1/100) so products of a 100-nonzero row are of order 1."""
    scale = 1.0 / np.sqrt(size * density)
    return sps.random(
        size, size, density=density, format="csr", dtype=dtype,
        random_state=rng,
        data_rvs=lambda s: values(rng, s, dtype, scale),
    )


def config3_bsr(rng, size, dtype, bs, block_density=0.05):
    """BASELINE config 3: BSR, 8192 x 8192, 5% of blocks stored."""
    nb = size // bs
    pattern = sps.random(nb, nb, density=block_density, format="csr",
                         random_state=rng)
    scale = 1.0 / np.sqrt(bs * nb * block_density)
    data = values(rng, (pattern.nnz, bs, bs), dtype, scale)
    return sps.bsr_matrix((data, pattern.indices, pattern.indptr),
                          shape=(size, size))


def spmv_csr(rng, size, per_row=10):
    """CSR f64, 1,000,000 x 1,000,000, 10 nonzeros per row: one column in
    each tenth of the width, so rows are sorted and free of repeats."""
    band = size // per_row
    cols = (rng.integers(0, band, (size, per_row))
            + np.arange(per_row) * band).reshape(-1)
    indptr = np.arange(0, size * per_row + 1, per_row)
    data = values(rng, size * per_row, np.float64, 1.0 / np.sqrt(per_row))
    return sps.csr_matrix((data, cols, indptr), shape=(size, size))


def path_inputs():
    """Phase 3's operands (and phases 4 and 6's), made from SEED + 1."""
    rng = np.random.default_rng(SEED + 1)
    n1, n3, nc = SIZES["config1"], SIZES["config3"], SIZES["complex"]
    a1 = config1_csr(rng, n1)
    b1 = values(rng, (n1, 128), np.float64)
    d1 = values(rng, (128, n1), np.float64)
    bsrs = {(bs, dt): config3_bsr(rng, n3, dt, bs)
            for bs in (64, 128) for dt in (np.float32, np.float64)}
    b3 = {dt: values(rng, (n3, 256), dt) for dt in (np.float32, np.float64)}
    out3 = {key: values(rng, (n3, 256), key[1]) for key in bsrs}
    av = spmv_csr(rng, SIZES["spmv"])
    xv = values(rng, av.shape[1], np.float64)
    xt = values(rng, av.shape[0], np.float64)
    ac = config1_csr(rng, nc, np.complex128)
    bc = values(rng, (nc, 64), np.complex128)
    # Complex BSR: K1's CUDA-core variant.
    abc = config3_bsr(rng, nc, np.complex128, 16)
    # The other layouts of the path: CSC (K2 on its CSR), dense x BSR (K1
    # on transposed blocks), BSR x vector (K3 on its element CSR).
    a1c = a1.tocsc()
    d3 = values(rng, (256, n3), np.float64)
    x3 = values(rng, n3, np.float64)
    return {"a1": a1, "b1": b1, "d1": d1, "bsrs": bsrs, "b3": b3,
            "out3": out3, "av": av, "xv": xv, "xt": xt, "ac": ac, "bc": bc,
            "abc": abc, "a1c": a1c, "d3": d3, "x3": x3}


def main_path():
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch.ops import bsr, csr

    cases = {}

    def check(name, res, ref, decimal):
        if res.shape != ref.shape or not np.isfinite(res).all():
            raise AssertionError(f"{name}: shape {res.shape} or non-finite")
        np.testing.assert_array_almost_equal(res, ref, decimal=decimal)
        cases[name] = {"shape": list(res.shape), "dtype": str(res.dtype),
                       "max_abs_err": float(np.abs(res - ref).max())}

    inputs = path_inputs()
    (a1, b1, d1, bsrs, b3, out3, av, xv, xt, ac, bc, abc, a1c, d3, x3) = (
        inputs[k] for k in ("a1", "b1", "d1", "bsrs", "b3", "out3", "av",
                            "xv", "xt", "ac", "bc", "abc", "a1c", "d3",
                            "x3"))
    a3 = bsrs[(64, np.float64)]

    reset_launches()
    with plain_versions_refused():
        t0 = time.perf_counter()
        r1 = sdt.dot_product(a1, b1)
        r1t = sdt.dot_product(d1, a1)
        r3 = {}
        for (bs, dt), a3 in bsrs.items():
            out = out3[(bs, dt)].copy()
            r3[(bs, dt)] = sdt.dot_product(a3, b3[dt], out=out,
                                           out_scalar=2.0)
            if r3[(bs, dt)] is not out:
                raise AssertionError("dot_product(out=...) did not return "
                                     "out")
        rv = sdt.dot_product(av, xv)
        rvt = sdt.dot_product(xt, av)
        rc = sdt.dot_product(ac, bc)
        r1c = sdt.dot_product(a1c, b1)
        r3t = sdt.dot_product(d3, a3)
        r3v = sdt.dot_product(a3, x3)
        rbc = sdt.dot_product(abc, bc)
        seconds = time.perf_counter() - t0
    launches = read_launches()
    # The four config-3 calls and dense x BSR on the tensor cores, the
    # complex BSR (bs 16) on their complex instances.
    expected = {name: 0 for name in launches}
    expected.update(K1_bsr_spmm_tc=len(bsrs) + 1, K1_bsr_spmm_tc_complex=1,
                    K2_csr_spmm=4, K3_csr_spmv=3)
    if (launches != expected or bsr.bsr_spmm.launches
            != launches["K1_bsr_spmm_tc"] + launches["K1_bsr_spmm_simt"]
            + launches["K1_bsr_spmm_tc_complex"]):
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    check("config1_csr_f64_spmm", r1, a1 @ b1, 6)
    check("config1_dense_x_csr_f64", r1t, (a1.T @ d1.T).T, 6)
    for (bs, dt), a3 in bsrs.items():
        ref = (a3.astype(np.float64) @ b3[dt].astype(np.float64)
               + 2.0 * out3[(bs, dt)].astype(np.float64))
        check(f"config3_bsr{bs}_{np.dtype(dt).name}_out",
              r3[(bs, dt)], ref, 6 if dt == np.float64 else 5)
    check("spmv_csr_f64_1M", rv, av @ xv, 6)
    check("vector_x_csr_f64_1M", rvt, av.T @ xt, 6)
    check("csr_c128_spmm", rc, ac @ bc, 6)
    check("config1_csc_f64_spmm", r1c, a1 @ b1, 6)
    check("config3_dense_x_bsr64_f64", r3t, (a3.T @ d3.T).T, 6)
    check("config3_bsr64_f64_x_vector", r3v, a3 @ x3, 6)
    check("bsr16_c128_spmm", rbc, abc @ bc, 6)
    emit(3, seconds=seconds, launches=launches, cases=cases)
    return launches, inputs


# ---------------------------------------------------------------------------
# Phase 3, sparse x sparse: dot_product, gram_matrix and sypr
# ---------------------------------------------------------------------------

SPGEMM_PLAIN = ("spgemm_plain", "csr_spgemm_count_plain",
                "csr_spgemm_fill_plain", "csr_spgemm_dense_plain",
                "spgemm_plain_batched", "csr_spgemm_fill_batched_plain",
                "csr_spgemm_dense_batched_plain")


def demo_x():
    """The reference demo's X: 500 x 5000 CSR at 21.2%, f64 (``bench.py``,
    ``random_state=100``)."""
    return sps.random(500, 5000, density=0.212, format="csr",
                      dtype=np.float64, random_state=100)


def random_coo_csr(rng, m, nnz):
    """m x m CSR from nnz random (row, col, N(0, 1)) triples, duplicates
    summed (as ``tests/test_spgemm_esc.py`` and ``test_gram_matrix.py``
    build their 1M and 50k matrices)."""
    a = sps.csr_matrix((rng.standard_normal(nnz),
                        (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
                       shape=(m, m))
    a.sum_duplicates()
    a.sort_indices()
    return a


def spgemm_inputs():
    """Operands of cases a-e: the demo X, BASELINE config 4's complex
    gram, a 1M x 1M A @ A, config 3's BSR x BSR, a 50k-row sypr."""
    rng = np.random.default_rng(SEED + 2)
    x = demo_x()
    sypr_a = random_coo_csr(rng, 50_000, 60_000)
    sypr_b = random_coo_csr(rng, 50_000, 50_000)
    return {
        "x": x,
        # f32 values scaled by 1/16, so X @ X.T is of order 1 and decimal=5
        # measures f32's own rounding.
        "x32": (x / 16).astype(np.float32),
        "xc": (x + 0.5j * x).astype(np.complex128).tocsr(),
        "a1m": random_coo_csr(rng, 1_000_000, 2_000_000),
        "bsr_a": config3_bsr(rng, SIZES["config3"], np.float64, 64),
        "bsr_b": config3_bsr(rng, SIZES["config3"], np.float64, 64),
        "sypr_a": sypr_a,
        "sypr_b": (sypr_b + sypr_b.T).tocsr(),
    }


ALL_PLAIN = {"spgemm": SPGEMM_PLAIN,
             "csr": ("csr_spmm_plain", "csr_spmv_plain",
                     "csr_spmm_batched_plain"),
             "bsr": ("bsr_spmm_plain", "bsr_sddmm_plain",
                     "bsr_spmm_batched_plain", "bsr_sddmm_batched_plain"),
             "sddmm": ("csr_sddmm_plain", "csr_sddmm_batched_plain"),
             "spgemm_grad": ("csr_spgemm_sddmm_plain",
                             "csr_spgemm_sparse_sddmm_plain",
                             "csr_spgemm_sddmm_batched_plain",
                             "csr_spgemm_sparse_sddmm_batched_plain"),
             "densify": ("csr_densify_plain", "csr_indicator_plain"),
             "compact": ("csr_compact_plain",)}


class plain_versions_refused:
    """Inside the block, the plain versions of every kernel (K1-K9, K11,
    K12 and its indicator template, K13) raise:
    the main path must run the kernels, never their plain versions on the
    card."""

    def __enter__(self):
        self.saved = []

        def refuse(*args, **kwargs):
            raise AssertionError("a plain kernel version ran on the main path")

        for module, names in ALL_PLAIN.items():
            mod = importlib.import_module(f"sparse_dot_tpu_torch.ops.{module}")
            for name in names:
                self.saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def reset_launches():
    from sparse_dot_tpu_torch.ops import (bsr, compact, csr, densify, sddmm,
                                          spgemm, spgemm_grad)

    for fn in (csr.csr_spmm, csr.csr_spmv, bsr.bsr_spmm,
               spgemm.csr_spgemm_count, spgemm.csr_spgemm_fill,
               spgemm.csr_spgemm_dense, sddmm.csr_sddmm, bsr.bsr_sddmm,
               spgemm_grad.csr_spgemm_sddmm,
               spgemm_grad.csr_spgemm_sparse_sddmm, densify.csr_densify,
               densify.csr_indicator, compact.masked_compact):
        fn.launches = 0
    for fn in (bsr.bsr_spmm, bsr.bsr_sddmm):
        fn.launches_tc = fn.launches_tc_complex = fn.launches_simt = 0
    for fn in (csr.csr_spmm, sddmm.csr_sddmm, bsr.bsr_spmm, bsr.bsr_sddmm,
               spgemm.csr_spgemm_fill, spgemm.csr_spgemm_dense,
               spgemm_grad.csr_spgemm_sddmm,
               spgemm_grad.csr_spgemm_sparse_sddmm):
        fn.launches_batched = 0
    for fn in (bsr.bsr_spmm, bsr.bsr_sddmm):
        fn.launches_batched_tc = fn.launches_batched_simt = 0
        fn.launches_batched_tc_complex = 0
    csr.csr_spmm.launches_group = spgemm.csr_spgemm_fill.launches_group = 0
    bsr.bsr_spmm.launches_group = spgemm.csr_spgemm_dense.launches_group = 0


def read_batched():
    """The batched launches among ``read_launches``' counts, by kernel
    (K1 and K8 by variant)."""
    from sparse_dot_tpu_torch.ops import bsr, csr, sddmm, spgemm, spgemm_grad

    k1, k8 = bsr.bsr_spmm, bsr.bsr_sddmm
    return {"K1_bsr_spmm_tc": (k1.launches_batched_tc
                               - k1.launches_batched_tc_complex),
            "K1_bsr_spmm_tc_complex": k1.launches_batched_tc_complex,
            "K1_bsr_spmm_simt": k1.launches_batched_simt,
            "K2_csr_spmm": csr.csr_spmm.launches_batched,
            "K5_csr_spgemm_fill": spgemm.csr_spgemm_fill.launches_batched,
            "K6_csr_spgemm_dense": spgemm.csr_spgemm_dense.launches_batched,
            "K7_csr_sddmm": sddmm.csr_sddmm.launches_batched,
            "K8_bsr_sddmm_tc": (k8.launches_batched_tc
                                - k8.launches_batched_tc_complex),
            "K8_bsr_sddmm_tc_complex": k8.launches_batched_tc_complex,
            "K8_bsr_sddmm_simt": k8.launches_batched_simt,
            "K9_csr_spgemm_sddmm":
                spgemm_grad.csr_spgemm_sddmm.launches_batched,
            "K11_csr_spgemm_sparse_sddmm":
                spgemm_grad.csr_spgemm_sparse_sddmm.launches_batched}


def read_launches():
    from sparse_dot_tpu_torch.ops import (bsr, compact, csr, densify, sddmm,
                                          spgemm, spgemm_grad)

    return {
        "K1_bsr_spmm_tc": (bsr.bsr_spmm.launches_tc
                           - bsr.bsr_spmm.launches_tc_complex),
        "K1_bsr_spmm_tc_complex": bsr.bsr_spmm.launches_tc_complex,
        "K1_bsr_spmm_simt": bsr.bsr_spmm.launches_simt,
        "K2_csr_spmm": csr.csr_spmm.launches,
        "K3_csr_spmv": csr.csr_spmv.launches,
        "K4_csr_spgemm_count": spgemm.csr_spgemm_count.launches,
        "K5_csr_spgemm_fill": spgemm.csr_spgemm_fill.launches,
        "K6_csr_spgemm_dense": spgemm.csr_spgemm_dense.launches,
        "K7_csr_sddmm": sddmm.csr_sddmm.launches,
        "K8_bsr_sddmm_tc": (bsr.bsr_sddmm.launches_tc
                            - bsr.bsr_sddmm.launches_tc_complex),
        "K8_bsr_sddmm_tc_complex": bsr.bsr_sddmm.launches_tc_complex,
        "K8_bsr_sddmm_simt": bsr.bsr_sddmm.launches_simt,
        "K9_csr_spgemm_sddmm": spgemm_grad.csr_spgemm_sddmm.launches,
        "K11_csr_spgemm_sparse_sddmm":
            spgemm_grad.csr_spgemm_sparse_sddmm.launches,
        "K12_csr_densify": densify.csr_densify.launches,
        "K12_csr_indicator": densify.csr_indicator.launches,
        "K13_csr_compact": compact.masked_compact.launches,
    }


def check_sparse(cases, name, res, ref, decimal, fmt="csr", pattern=False):
    """A sparse result against scipy: format, dtype, shape, finite values,
    max |res - ref| within decimal; with ``pattern`` also equal indptr and
    indices (both sorted)."""
    if (res.format != fmt or res.dtype != ref.dtype
            or res.shape != ref.shape or not np.isfinite(res.data).all()):
        raise AssertionError(f"{name}: {res.format} {res.dtype} {res.shape}")
    err = float(abs(res - ref).max()) if res.nnz + ref.nnz else 0.0
    if not err < 1.5 * 10.0 ** -decimal:
        raise AssertionError(f"{name}: max |res - ref| = {err}")
    if pattern:
        r, o = res.tocsr(), ref.tocsr()
        r.sort_indices()
        o.sort_indices()
        if not (np.array_equal(r.indptr, o.indptr)
                and np.array_equal(r.indices, o.indices)):
            raise AssertionError(f"{name}: pattern differs from scipy")
    cases[name] = {"shape": list(res.shape), "dtype": str(res.dtype),
                   "nnz": int(res.nnz), "max_abs_err": err}


def spgemm_path():
    """Cases a-e through the public API, K4/K5/K6 launches counted."""
    import sparse_dot_tpu_torch as sdt

    inp = spgemm_inputs()
    x, x32, xc = inp["x"], inp["x32"], inp["xc"]
    out = np.full((x.shape[0], x.shape[0]), np.nan)

    reset_launches()
    with plain_versions_refused():
        t0 = time.perf_counter()
        r = {
            "a_x_xT_f64": sdt.dot_product(x, x.T),
            "a_x_xT_f32": sdt.dot_product(x32, x32.T),
            "a_x_xT_dense_out": sdt.dot_product(x, x.T, dense=True, out=out),
            "a_gram_xxT": sdt.gram_matrix(x, transpose=True),
            "a_gram_xxT_dense": sdt.gram_matrix(x, transpose=True,
                                                dense=True),
            "b_gram_c128_xTx": sdt.gram_matrix(xc, allow_complex=True),
            "b_gram_c128_xxT": sdt.gram_matrix(xc, transpose=True,
                                               allow_complex=True),
            "c_1M_a_x_a": sdt.dot_product(inp["a1m"], inp["a1m"]),
            "d_config3_bsr_x_bsr": sdt.dot_product(inp["bsr_a"],
                                                   inp["bsr_b"]),
            "e_sypr_50k": sdt.sypr(inp["sypr_a"], inp["sypr_b"]),
        }
        seconds = time.perf_counter() - t0
    launches = read_launches()
    # The dense X @ X.T and its dense gram: K12 once each (X^T is X's
    # transpose view) where the gate sends them to the densify route, else
    # K6.  The sparse-output products: K12, its indicator and K13's one
    # launch each (one densify for a transpose view) where the gate sends
    # them to the structural densify route, else K4 + K5 (sypr's two
    # products of 50k rows, case c and case d always: their dense
    # intermediates pass the cap, or the dense product is slower).
    dense_route = [xxt_dense_route(x), xxt_dense_route(x, True)]
    sparse_route = {name: sparse_dense_route(*shape)
                    for name, shape in spgemm_shapes(inp).items()}
    for name in ("c_1M_a_x_a", "d_config3_bsr_x_bsr", "e_sypr_50k"):
        if sparse_route[name]:
            raise AssertionError(f"the gate sends {name} to the densify "
                                 "route")
    routed = sum(sparse_route.values())
    expected = {name: 0 for name in launches}
    expected.update(K4_csr_spgemm_count=9 - routed,
                    K5_csr_spgemm_fill=9 - routed,
                    K6_csr_spgemm_dense=2 - sum(dense_route),
                    K12_csr_densify=sum(dense_route) + routed,
                    K12_csr_indicator=routed, K13_csr_compact=routed)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if r["a_x_xT_dense_out"] is not out:
        raise AssertionError("dot_product(dense=True, out=...) did not "
                             "return out")

    cases = {}
    xxt = x @ x.T
    check_sparse(cases, "a_x_xT_f64", r["a_x_xT_f64"], xxt, 6, pattern=True)
    x32d = x32.astype(np.float64)
    check_sparse(cases, "a_x_xT_f32", r["a_x_xT_f32"],
                 (x32d @ x32d.T).astype(np.float32), 5, pattern=True)
    np.testing.assert_array_almost_equal(out, xxt.toarray(), decimal=6)
    check_sparse(cases, "a_gram_xxT", r["a_gram_xxT"], sps.triu(xxt), 6,
                 pattern=True)
    np.testing.assert_array_almost_equal(
        r["a_gram_xxT_dense"], np.triu(xxt.toarray()), decimal=6)
    check_sparse(cases, "b_gram_c128_xTx", r["b_gram_c128_xTx"],
                 sps.triu(xc.T @ xc, format="csr"), 6)
    check_sparse(cases, "b_gram_c128_xxT", r["b_gram_c128_xxT"],
                 sps.triu(xc @ xc.T, format="csr"), 6)
    check_sparse(cases, "c_1M_a_x_a", r["c_1M_a_x_a"],
                 inp["a1m"] @ inp["a1m"], 6, pattern=True)
    d = r["d_config3_bsr_x_bsr"]
    if d.blocksize != (64, 64):
        raise AssertionError(f"BSR x BSR blocksize {d.blocksize}")
    check_sparse(cases, "d_config3_bsr_x_bsr", d,
                 inp["bsr_a"] @ inp["bsr_b"], 6, fmt="bsr")
    sa, sb = inp["sypr_a"], inp["sypr_b"]
    check_sparse(cases, "e_sypr_50k", r["e_sypr_50k"],
                 sps.triu(sa.T @ sb @ sa, format="csr"), 6)
    emit("3-spgemm", seconds=seconds, launches=launches, cases=cases,
         dense_x_xT_routes=["densify" if d else "K6" for d in dense_route],
         sparse_routes={name: "densify" if r else "K4+K5"
                        for name, r in sparse_route.items()})
    return launches, inp


def spgemm_shapes(inp):
    """The shapes of phase 3's sparse-output products that
    ``ops.host._prefer_densify_sparse_product`` reads: (m, k, n, nnz of
    op(A), of op(B), type, one operand (a transpose view), triangular);
    sypr's first product, A^T B, of its two."""
    x, xc, a1m = inp["x"], inp["xc"], inp["a1m"]
    f64, c128 = torch.float64, torch.complex128
    xxt = (500, 5000, 500, x.nnz, x.nnz)
    return {
        "a_x_xT_f64": (*xxt, f64, True),
        "a_x_xT_f32": (*xxt, torch.float32, True),
        "a_gram_xxT": (*xxt, f64, True, True),
        "b_gram_c128_xTx": (5000, 500, 5000, xc.nnz, xc.nnz, c128, True,
                            True),
        "b_gram_c128_xxT": (500, 5000, 500, xc.nnz, xc.nnz, c128, True,
                            True),
        "c_1M_a_x_a": (*a1m.shape, a1m.shape[1], a1m.nnz, a1m.nnz, f64,
                       False),
        "d_config3_bsr_x_bsr": (*inp["bsr_a"].shape, inp["bsr_b"].shape[1],
                                inp["bsr_a"].nnz, inp["bsr_b"].nnz, f64,
                                False),
        "e_sypr_50k": (50_000, 50_000, 50_000, inp["sypr_a"].nnz,
                       inp["sypr_b"].nnz, f64, False),
    }


def sparse_dense_route(m, k, n, a_nnz, b_nnz, dtype, one_operand,
                       triangular=False):
    """Whether ``ops.host._prefer_densify_sparse_product`` sends a
    sparse-output product to the structural densify route on the card."""
    from sparse_dot_tpu_torch.ops import host

    return host._prefer_densify_sparse_product(
        m, k, n, a_nnz, b_nnz, dtype, torch.device("cuda"), one_operand,
        triangular)


# ---------------------------------------------------------------------------
# Phase 3, the densify route: dot_product where the gates send it
# ---------------------------------------------------------------------------


def spmm_dense_route(a, n, dtype, transpose=False):
    """Whether ``ops.host._prefer_densify`` sends op(a) @ (k, n) to the
    densify route on the card (a BSR against K1's forecast)."""
    from sparse_dot_tpu_torch.ops import host

    m, k = a.shape[::-1] if transpose else a.shape
    return host._prefer_densify(
        m, k, n, a.nnz, dtype, torch.device("cuda"),
        a.blocksize[0] if a.format == "bsr" else None)


def xxt_dense_route(x, triangular=False, dtype=torch.float64):
    """Whether ``ops.host._prefer_densify_product`` sends the dense
    X @ X.T (one operand; the gram with ``triangular``) to the densify
    route on the card."""
    from sparse_dot_tpu_torch.ops import host

    return host._prefer_densify_product(
        x.shape[0], x.shape[1], x.shape[0], x.nnz, x.nnz, dtype,
        torch.device("cuda"), True, triangular)


def densify_path():
    """Phase 3's densify calls through ``dot_product`` and
    ``gram_matrix``, each alone with the counts set to 0 and the plain
    versions made to raise, with its exact launches (K12 1 on the route,
    K2 or K6 0; the kernel's 1 elsewhere) and its result against scipy at
    decimal 6 (f64) or 5 (f32): the demo X @ B (n = 128; f64, f32, and f64
    with ``out``/``out_scalar``), config 1's shape at 10% as CSR (also with
    ``out``/``out_scalar``), CSC and dense x CSR, the demo X @ X.T with
    dense output and its dense gram, a
    call below the crossover (config 1 at 1%) and one with inf, -inf and
    nan in B at 10% and n = 512 (K12, then the finite check turns it to
    K2: scipy's inf and nan).  Returns the launches by kernel."""
    import sparse_dot_tpu_torch as sdt

    rng = np.random.default_rng(SEED + 6)
    x = demo_x()
    x32 = (x / 16).astype(np.float32)
    n1 = SIZES["config1"]
    bx = values(rng, (x.shape[1], 128), np.float64)
    out_x = values(rng, (x.shape[0], 128), np.float64)
    a10 = config1_csr(rng, n1, density=0.1)
    a10c = a10.tocsc()
    a1 = config1_csr(rng, n1)
    b1 = values(rng, (n1, 128), np.float64)
    d1 = values(rng, (128, n1), np.float64)
    # n = 512, where the densify route is far ahead at 10%: rows with
    # entries in columns 3 and 4 meet inf and -inf (nan where their signs
    # cancel), rows with one in column 6 meet nan.
    b_inf = values(rng, (n1, 512), np.float64)
    b_inf[3, 5], b_inf[4, 5], b_inf[6, 7] = np.inf, -np.inf, np.nan
    cases, routes, moved = {}, {}, {}

    def call(name, fn, dense, kernel, also=None):
        """fn() alone; K12 once on the route, ``kernel`` once off it (and
        the launches ``also``)."""
        return run(name, fn,
                   {"K12_csr_densify" if dense else kernel: 1,
                    **(also or {})}, "densify" if dense else kernel)

    def run(name, fn, expect, route):
        """fn() alone, with exactly the launches ``expect``."""
        reset_launches()
        with plain_versions_refused():
            t0 = time.perf_counter()
            res = fn()
            seconds = time.perf_counter() - t0
        got = {k: v for k, v in read_launches().items() if v}
        if got != expect:
            raise AssertionError(f"{name}: launched {got}, expected "
                                 f"{expect}")
        routes[name] = route
        moved[name] = got
        cases[name] = {"seconds": seconds}
        return res

    def check(name, res, ref, decimal, finite=True):
        if res.shape != ref.shape or (finite and not np.isfinite(res).all()):
            raise AssertionError(f"{name}: shape {res.shape} or non-finite")
        np.testing.assert_array_almost_equal(res, ref, decimal=decimal)
        ok = np.isfinite(ref)
        cases[name].update(shape=list(res.shape), dtype=str(res.dtype),
                           max_abs_err=float(np.abs(res - ref)[ok].max()))

    f64, f32 = torch.float64, torch.float32
    check("demo_x_at_b_f64", call(
        "demo_x_at_b_f64", lambda: sdt.dot_product(x, bx),
        spmm_dense_route(x, 128, f64), "K2_csr_spmm"), x @ bx, 6)
    bx32 = bx.astype(np.float32)
    check("demo_x_at_b_f32", call(
        "demo_x_at_b_f32", lambda: sdt.dot_product(x32, bx32),
        spmm_dense_route(x32, 128, f32), "K2_csr_spmm"),
        (x32.astype(np.float64) @ bx32.astype(np.float64)), 5)
    out = out_x.copy()
    res = call("demo_x_at_b_f64_out", lambda: sdt.dot_product(
        x, bx, out=out, out_scalar=2.0), spmm_dense_route(x, 128, f64),
        "K2_csr_spmm")
    if res is not out:
        raise AssertionError("dot_product(out=...) did not return out")
    check("demo_x_at_b_f64_out", res, x @ bx + 2.0 * out_x, 6)
    ref10 = a10 @ b1
    dense10 = spmm_dense_route(a10, 128, f64)
    check("config1_10pct_csr", call(
        "config1_10pct_csr", lambda: sdt.dot_product(a10, b1), dense10,
        "K2_csr_spmm"), ref10, 6)
    out1 = values(rng, (n1, 128), np.float64)
    out = out1.copy()
    res = call("config1_10pct_csr_out", lambda: sdt.dot_product(
        a10, b1, out=out, out_scalar=2.0), dense10, "K2_csr_spmm")
    if res is not out:
        raise AssertionError("dot_product(out=...) did not return out")
    check("config1_10pct_csr_out", res, ref10 + 2.0 * out1, 6)
    check("config1_10pct_csc", call(
        "config1_10pct_csc", lambda: sdt.dot_product(a10c, b1), dense10,
        "K2_csr_spmm"), ref10, 6)
    check("config1_10pct_dense_x_csr", call(
        "config1_10pct_dense_x_csr", lambda: sdt.dot_product(d1, a10),
        spmm_dense_route(a10, 128, f64, transpose=True), "K2_csr_spmm"),
        (a10.T @ d1.T).T, 6)
    xxt = (x @ x.T).toarray()
    check("demo_x_xT_dense", call(
        "demo_x_xT_dense", lambda: sdt.dot_product(x, x.T, dense=True),
        xxt_dense_route(x), "K6_csr_spgemm_dense"), xxt, 6)
    check("demo_gram_xxT_dense", call(
        "demo_gram_xxT_dense", lambda: sdt.gram_matrix(
            x, transpose=True, dense=True), xxt_dense_route(x, True),
        "K6_csr_spgemm_dense"), np.triu(xxt), 6)
    if spmm_dense_route(a1, 128, f64):
        raise AssertionError("the gate sends config 1 at 1% to the densify "
                             "route")
    check("config1_1pct_below_crossover", call(
        "config1_1pct_below_crossover", lambda: sdt.dot_product(a1, b1),
        False, "K2_csr_spmm"), a1 @ b1, 6)
    if not spmm_dense_route(a10, 512, f64):
        raise AssertionError("the gate keeps config 1 at 10%, n = 512 on "
                             "K2: the inf case would not reach the finite "
                             "check")
    ref_inf = a10 @ b_inf
    # K12 runs before the finite check's host read; the product is K2's.
    res = call("config1_10pct_inf_in_b", lambda: sdt.dot_product(a10, b_inf),
               False, "K2_csr_spmm", also={"K12_csr_densify": 1})
    if not (np.array_equal(np.isnan(res), np.isnan(ref_inf))
            and np.array_equal(np.isinf(res), np.isinf(ref_inf))
            and np.isinf(ref_inf).any() and np.isnan(ref_inf).any()):
        raise AssertionError("inf in B: the inf and nan of scipy's result "
                             "differ")
    check("config1_10pct_inf_in_b", res, ref_inf, 6, finite=False)
    sparse_path(x, run, cases, rng)
    if not any(r == "densify" for r in routes.values()):
        raise AssertionError("no phase-3 call took the densify route")
    totals = {name: 0 for name in KERNELS}
    for got in moved.values():
        for k, v in got.items():
            totals[k] += v
    emit("3-densify", routes=routes, launches=moved, cases=cases)
    return totals


def structural(a, b):
    """The structural pattern of a @ b (scipy CSR, rows sorted): the
    product of the indicators, whose sums of ones never cancel."""
    def ones(m):
        m = m.tocsr()
        return sps.csr_matrix((np.ones(m.nnz), m.indices, m.indptr),
                              shape=m.shape)
    p = (ones(a) @ ones(b)).tocsr()
    p.sort_indices()
    return p


def sparse_path(x, run, cases, rng):
    """Phase 3's sparse-output densify calls (``densify_path``), each alone
    with its exact launches: the demo X @ X.T and its gram (K12 once, its
    indicator once, K13 once, no K4 or K5), their patterns
    scipy's structural product (explicit zeros included), their values
    scipy's at decimal 6; X with inf and nan (the route up to its host
    read, then K4 + K5: scipy's inf and nan); dot_product(Xd, Xd.T) twice
    on one container (the second call K13 alone: the kept planes); a dense
    x BSR above the gate (K12, not K1: a complex BSR of 90% blocks, past
    the gate's crossover near 72% now that K1 runs complex values on the
    tensor cores)."""
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch import formats

    if not sparse_dense_route(500, 5000, 500, x.nnz, x.nnz, torch.float64,
                              True):
        raise AssertionError("the gate keeps the demo X @ X.T on K4 + K5")
    on_route = {"K12_csr_densify": 1, "K12_csr_indicator": 1,
                "K13_csr_compact": 1}
    xxt, pattern = x @ x.T, structural(x, x.T)

    def check(name, res, ref, pat, decimal=6):
        res = res.tocsr()
        res.sort_indices()
        if not (np.array_equal(res.indptr, pat.indptr)
                and np.array_equal(res.indices, pat.indices)):
            raise AssertionError(f"{name}: pattern differs from scipy's "
                                 "structural product")
        np.testing.assert_array_almost_equal(res.toarray(), ref.toarray(),
                                             decimal=decimal)
        ok = np.isfinite(ref.toarray())
        cases[name].update(nnz=int(res.nnz), max_abs_err=float(np.abs(
            res.toarray() - ref.toarray())[ok].max()))

    check("sparse_x_xT", run("sparse_x_xT", lambda: sdt.dot_product(
        x, x.T), on_route, "densify"), xxt, pattern)
    check("sparse_gram_xxT", run("sparse_gram_xxT", lambda: sdt.gram_matrix(
        x, transpose=True), on_route, "densify"), sps.triu(xxt),
        sps.triu(pattern, format="csr"))
    x_inf = x.copy()
    x_inf.data[0], x_inf.data[x.indptr[7]] = np.inf, np.nan
    ref = x_inf @ x_inf.T
    check("sparse_x_xT_nonfinite", run(
        "sparse_x_xT_nonfinite", lambda: sdt.dot_product(x_inf, x_inf.T),
        {"K12_csr_densify": 1, "K12_csr_indicator": 1, "K13_csr_compact": 1,
         "K4_csr_spgemm_count": 1, "K5_csr_spgemm_fill": 1}, "K4+K5"),
        ref, pattern)
    if not np.isnan(ref.data).any() or not np.isinf(ref.data).any():
        raise AssertionError("the non-finite case lacks inf or nan")
    xd = formats.to_device(x)
    first = run("sparse_container_first", lambda: sdt.dot_product(
        xd, xd.T), on_route, "densify")
    check("sparse_container_first", first, xxt, pattern)
    check("sparse_container_repeat", run(
        "sparse_container_repeat", lambda: sdt.dot_product(xd, xd.T),
        {"K13_csr_compact": 1}, "densify, kept planes"), xxt, pattern)
    # Blocks of 20 (K1 on the CUDA cores): complex K1 on the tensor cores
    # ran faster than the densify route at every density of blocks up to
    # 90% at this shape (``compare_k7_k13.py bsr_gate``).
    nb = SIZES["complex"] // 20
    blocks = sps.random(nb, nb, density=0.5, format="csr", random_state=rng)
    a = sps.bsr_matrix((values(rng, (blocks.nnz, 20, 20), np.complex128,
                               1 / 45), blocks.indices, blocks.indptr),
                       shape=(SIZES["complex"],) * 2)
    d = values(rng, (64, SIZES["complex"]), np.complex128)
    if not spmm_dense_route(a, 64, torch.complex128, transpose=True):
        raise AssertionError("the gate keeps the dense x BSR case on K1")
    res = run("dense_x_bsr20_c128_50pct", lambda: sdt.dot_product(d, a),
              {"K12_csr_densify": 1}, "densify")
    ref = (a.T @ d.T).T
    np.testing.assert_array_almost_equal(res, ref, decimal=6)
    cases["dense_x_bsr20_c128_50pct"].update(
        shape=list(res.shape), max_abs_err=float(np.abs(res - ref).max()))


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------


def time_set(kernel_fn, plain_fn, library_fn=None, reps=REPS,
             yardstick_fn=None, beside=None):
    """The REPS times in ms of the kernel, its plain version, when given
    the one PyTorch call that computes the same function (``library_fn``)
    and another way to compute it (``yardstick_fn``; both are yardsticks,
    which the port never calls), and ``beside`` ({name: fn}, other calls
    to time in the same turns), taken in turns, and the largest
    |kernel - plain|.  Before each launch a 1 GiB read evicts L2
    with clean lines (a write would leave dirty lines to drain inside the
    timed launch) and keeps the card busy for ~0.3 ms while the host
    enqueues the call, so the events time the device, not the Python call
    (a 256 MB read covered ~85 us, less than the plain versions' host side
    of up to 0.36 ms).  The yardstick's result is held against the plain
    version's too.  Returns (kernel, plain, library or None, yardstick or
    None, error, {name: times} of ``beside``)."""
    out_k, out_p = kernel_fn(), plain_fn()
    err = compare(out_k, out_p, out_k.dtype)
    fns = {"plain": plain_fn, "kernel": kernel_fn}
    if library_fn is not None:
        library_fn()  # warm-up (cuSPARSE handles and buffers)
        fns["library"] = library_fn
    if yardstick_fn is not None:
        compare(yardstick_fn(), out_p, out_k.dtype)
        fns["yardstick"] = yardstick_fn
    for name, fn in (beside or {}).items():
        fn()  # warm-up
        fns["beside " + name] = fn
    del out_k, out_p
    times = time_turns(fns, reps)
    return (times["kernel"], times["plain"], times.get("library"),
            times.get("yardstick"), err,
            {name: times["beside " + name] for name in beside or {}})


def time_turns(fns, reps):
    """{name: the ``reps`` times in ms of ``fns[name]()``}, the calls taken
    in turns, each after a 1 GiB read (``time_set``)."""
    flush = torch.ones(256 << 20, dtype=torch.float32, device="cuda")
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def spread(times):
    """Median, p10 and p90 of a list of ms."""
    p10, p50, p90 = np.percentile(times, [10, 50, 90])
    return float(p50), float(p10), float(p90)


# The H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, the
# CUDA cores' FLOP/s by value type, and the tensor cores' as K1 and K8 use
# them (f64 MMA; f32 as 3xTF32, three TF32 MMAs per product; complex
# values as four real products of their parts, c128 on f64 MMA and c64
# on 3xTF32, so at the rate of their part's type).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_FLOPS = {torch.float32: 67e12, torch.complex64: 67e12,
                   torch.float64: 34e12, torch.complex128: 34e12}
TENSOR_CORE_FLOPS = {torch.float64: 67e12, torch.float32: 495e12 / 3,
                     torch.complex128: 67e12, torch.complex64: 495e12 / 3}


def peak_flops(dtype):
    """The card's highest FLOP/s for ``dtype``, on whichever units reach
    it: the least time of a kernel's operations, whatever units it uses."""
    return max(CUDA_CORE_FLOPS[dtype], TENSOR_CORE_FLOPS.get(dtype, 0.0))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def flops_per_product(dtype):
    """FLOPs of one multiply-add: 2 real, 8 complex."""
    return 8 if dtype.is_complex else 2


def bound(moved, flop, peak):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    FLOPs over ``peak``, and which of the two it is."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bound(indptr, indices, data, b, c0=None):
    """K2/K3's bound: A's arrays, the rows of b that A names (each once),
    C0 and C; one multiply-add per nonzero and column."""
    n = 1 if b.dim() == 1 else b.shape[1]
    rows = int(torch.unique(indices).numel())
    out = (indptr.numel() - 1) * n * b.element_size()
    moved = (nbytes(indptr, indices, data, c0) + rows * n * b.element_size()
             + out)
    flop = flops_per_product(b.dtype) * indices.numel() * n
    return bound(moved, flop, peak_flops(b.dtype))


def sddmm_bound(indptr, indices, g, b):
    """K7's bound: A's indices, G, the rows of B that A names (each once)
    and the output; one multiply-add per entry and column."""
    n = g.shape[1]
    rows = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices, g) + rows * n * b.element_size()
             + indices.numel() * g.element_size())
    flop = flops_per_product(g.dtype) * indices.numel() * n
    return bound(moved, flop, peak_flops(g.dtype))


def sddmm_library(indptr, indices, g, b, shape):
    """cuSPARSE SDDMM through torch: ``torch.sparse.sampled_addmm`` of G
    and B^T (conj(B)^T for complex values, conjugated before the call) at
    A's pattern, beta = 0."""
    def make():
        a = torch.sparse_csr_tensor(
            indptr, indices, torch.zeros(indices.numel(), dtype=g.dtype,
                                         device=g.device), size=shape)
        bt = b.conj_physical().mT if b.is_complex() else b.mT
        return ((lambda: torch.sparse.sampled_addmm(a, g, bt, beta=0.0)),
                "torch.sparse.sampled_addmm(A_csr, G, B^T, beta=0) "
                "(cuSPARSE SDDMM)")
    return library_call(make)


def bsr_bound(indptr, indices, data, b, c0=None):
    """K1's bound: the BSR's arrays, the block rows of b it names, C0 and
    C; bs * bs multiply-adds per stored block and column, at the card's
    highest rate for the value type (``peak_flops``: the tensor cores' in
    every type, complex ones as four real products of their parts)."""
    nblocks, bs, _ = data.shape
    n = b.shape[1]
    panels = int(torch.unique(indices).numel())
    out = (indptr.numel() - 1) * bs * n * b.element_size()
    moved = (nbytes(indptr, indices, data, c0)
             + panels * bs * n * b.element_size() + out)
    flop = flops_per_product(b.dtype) * nblocks * bs * bs * n
    peak = peak_flops(b.dtype)
    return bound(moved, flop, peak)


def library_call(make):
    """(fn, note): ``make()`` builds the yardstick's operands as a user
    would and returns the call; note names the call, or the error with
    which torch refused it (then fn is None)."""
    try:
        fn, note = make()
        fn()
        torch.cuda.synchronize()
        return fn, note
    except Exception as exc:  # noqa: BLE001  (a refusal is a result here)
        return None, f"none: {type(exc).__name__}: {str(exc)[:200]}"


def csr_library(indptr, indices, data, b, shape, c0=None, beta=None):
    """cuSPARSE through torch: SpMM (``torch.sparse.mm``, or
    ``torch.addmm`` with C0) or, for 1-d b, SpMV (``A @ x``)."""
    def make():
        a = torch.sparse_csr_tensor(indptr, indices, data, size=shape)
        if b.dim() == 1:
            return (lambda: a @ b), "A_csr @ x (cuSPARSE SpMV)"
        if c0 is not None:
            return ((lambda: torch.addmm(c0, a, b, beta=beta)),
                    "torch.addmm(c0, A_csr, B, beta) (cuSPARSE SpMM)")
        return (lambda: torch.sparse.mm(a, b)), \
            "torch.sparse.mm(A_csr, B) (cuSPARSE SpMM)"
    return library_call(make)


def bsr_library(indptr, indices, data, b, shape, c0=None, beta=None):
    """The same on ``torch.sparse_bsr_tensor``."""
    def make():
        a = torch.sparse_bsr_tensor(indptr, indices, data, size=shape)
        if c0 is not None:
            return ((lambda: torch.addmm(c0, a, b, beta=beta)),
                    "torch.addmm(c0, A_bsr, B, beta)")
        return (lambda: torch.sparse.mm(a, b)), "torch.sparse.mm(A_bsr, B)"
    return library_call(make)


def timed_row(kernel, shape, kernel_fn, plain_fn, bound_of, library=(None,
              "none: no single PyTorch call computes this"), reps=REPS,
              yardstick=None, beside=None, device_match=None, **extra):
    """One phase-4 row: times of kernel, plain version, library call and
    (``yardstick``: (fn, note)) another way to compute the same, the
    bound and the share of it that the kernel reaches; ``beside``
    ({name: fn}) timed in the same turns, their spreads in ``beside``.
    With ``device_match`` also ``device_ms``: the kernel's and each
    beside call's kernels named so, from a profiler trace
    (``kernel_device_ms``)."""
    lib_fn, lib_note = library
    yard_fn, yard_note = yardstick or (None, None)
    kt, pt, lt, yt, err, bt = time_set(kernel_fn, plain_fn, lib_fn, reps,
                                       yard_fn, beside)
    (ms, p10, p90), (plain_ms, pp10, pp90) = spread(kt), spread(pt)
    bound_ms, bound_by = bound_of
    row = {"kernel": kernel, "shape": shape, "ms": ms, "p10": p10,
           "p90": p90, "plain_ms": plain_ms, "plain_p10": pp10,
           "plain_p90": pp90, "max_abs_err": err, "bound_ms": bound_ms,
           "bound_by": bound_by, "share": bound_ms / ms,
           "library_ms": None if lt is None else spread(lt)[0],
           "library": lib_note, "reps": reps, **extra}
    if lt is not None:
        row["library_p10"], row["library_p90"] = spread(lt)[1:]
    if yt is not None:
        row["yardstick_ms"], row["yardstick_p10"], row["yardstick_p90"] = \
            spread(yt)
        row["yardstick"] = yard_note
    if bt:
        row["beside"] = {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                         for name, t in bt.items()}
    if device_match:
        row["device_ms"] = {
            name: kernel_device_ms(fn, device_match)
            for name, fn in {"kernel": kernel_fn, **(beside or {})}.items()}
    return row


def k10_row(inputs):
    """Phase 4's row of K10 (``formats.coo_to_sorted_csr``: one stable
    sort, torch code and not a hand kernel, so its plain version is
    itself) at config 1's matrix as expanded COO in a random order, int32
    ids, f64 values; bound: the COO read once and the CSR written once."""
    from sparse_dot_tpu_torch import formats

    a = inputs["a1"]
    rng = np.random.default_rng(SEED + 45)
    order = rng.permutation(a.nnz)
    rows = cuda(np.repeat(np.arange(a.shape[0], dtype=np.int32),
                          np.diff(a.indptr))[order])
    cols = cuda(a.indices.astype(np.int32)[order])
    vals = cuda(a.data[order])

    def sort():  # the whole conversion; its values stand for the result
        return formats.coo_to_sorted_csr(rows, cols, vals, a.shape)[2]

    moved = nbytes(rows, cols, vals) + nbytes(cols, vals) + (
        a.shape[0] + 1) * 4
    return timed_row(
        "K10_coo_to_sorted_csr",
        f"config1 COO f64 {a.shape[0]}x{a.shape[1]}, {a.nnz} entries in a "
        "random order, int32 ids (torch code: the plain version is itself)",
        sort, sort, bound(moved, 0, peak_flops(torch.float64)),
        (None, "none: torch's COO -> CSR sums repeated entries, which K10 "
               "keeps apart"))


def sorts_in(fn, *args):
    """(fn(*args), the stable sorts of ``formats.sort_csr_indices``, K10,
    that it ran)."""
    from sparse_dot_tpu_torch import formats

    before = formats.sort_csr_indices.calls
    out = fn(*args)
    return out, formats.sort_csr_indices.calls - before


def timings(inputs, solver_inp):
    """Phase 4: K1, K2 and K3 at the phase-3 shapes and at the solvers'
    matrices (the 1M Laplacian, the convection-diffusion matrix and CGLS's
    A and A^T), each with its plan as the main path passes it (built once,
    cached on the container)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr, csr

    rows = []

    def k2(shape, A, b, transpose=False, **extra):
        ip, ix, dv = A.csr_arrays(transpose)
        dv = dv.to(b.dtype)
        plan = A.csr_plan(transpose)
        m = ip.numel() - 1
        rows.append(timed_row(
            "K2_csr_spmm", shape,
            lambda: csr.csr_spmm(ip, ix, dv, b, plan=plan),
            lambda: csr.csr_spmm_plain(ip, ix, dv, b),
            csr_bound(ip, ix, dv, b),
            csr_library(ip, ix, dv, b, (m, b.shape[0])),
            schedule=list(csr.spmm_schedule(
                b.shape[1], b.dtype, ix.numel() / m)), **extra))

    def k3(shape, A, x, transpose=False):
        ip, ix, dv = A.csr_arrays(transpose)
        dv = dv.to(x.dtype)
        plan = A.csr_plan(transpose, spmv=True)
        rows.append(timed_row(
            "K3_csr_spmv", shape,
            lambda: csr.csr_spmv(ip, ix, dv, x, plan=plan),
            lambda: csr.csr_spmv_plain(ip, ix, dv, x),
            csr_bound(ip, ix, dv, x),
            csr_library(ip, ix, dv, x, (ip.numel() - 1, x.shape[0]))))

    rng = np.random.default_rng(SEED + 4)
    n1, n3, nc = SIZES["config1"], SIZES["config3"], SIZES["complex"]
    nv = SIZES["spmv"]
    A1 = formats.to_device(inputs["a1"])
    k2(f"config1 CSR f64 {n1}x{n1} 1% @ ({n1},128)", A1, cuda(inputs["b1"]))
    k2(f"config1 (128,{n1}) @ CSR f64 (transposed CSR)", A1,
       cuda(inputs["d1"].T), transpose=True)
    k2(f"CSR c128 {nc}x{nc} 1% @ ({nc},64)", formats.to_device(inputs["ac"]),
       cuda(inputs["bc"]))
    lap = formats.to_device(solver_inp["lap"])
    cgls = formats.to_device(solver_inp["cgls_a"])
    nl, (mc, kc) = lap.shape[0], cgls.shape
    for n in (1, 4, 16):
        k2(f"1M Laplacian, 5.0 M nnz @ ({nl}, {n})", lap,
           cuda(rng.standard_normal((nl, n))))
    for n in (1, 4):
        k2(f"CGLS A 1.2Mx50k @ (50k, {n})", cgls,
           cuda(rng.standard_normal((kc, n))))
        k2(f"CGLS A^T 50kx1.2M @ (1.2M, {n})", cgls,
           cuda(rng.standard_normal((mc, n))), transpose=True)
    k3(f"CSR f64 {nv}x{nv}, 10 per row @ ({nv},)",
       formats.to_device(inputs["av"]), cuda(inputs["xv"]))
    k3("1M Laplacian, 5.0 M nnz", lap, cuda(rng.standard_normal(nl)))
    k3("1M convection-diffusion", formats.to_device(solver_inp["cd"]),
       cuda(rng.standard_normal(nl)))
    k3("CGLS A 1.2Mx50k @ (50k,)", cgls, cuda(rng.standard_normal(kc)))
    k3("CGLS A^T 50kx1.2M @ (1.2M,)", cgls, cuda(rng.standard_normal(mc)),
       transpose=True)
    del lap, cgls
    k7_rows(rows, inputs, rng)
    k8_rows(rows, inputs, rng)

    k1_rows(rows, inputs)
    # After every kernel's own rows: the final line reads each one's first.
    batched_rows(rows, inputs, rng)
    emit(4, reps=REPS, rows=rows,
         timer="cuda events, median (p10, p90), 1 GiB read before each; "
               "library: the one torch call, warmed up, timed the same way",
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                "cuda_core_flops": {str(k): v for k, v in
                                    CUDA_CORE_FLOPS.items()},
                "tensor_core_flops": {str(k): v for k, v in
                                      TENSOR_CORE_FLOPS.items()}})
    return rows


def k1_rows(rows, inputs):
    """K1's phase-4 rows: config 3 (8192^2 BSR, 5% of blocks) at bs 64
    and 128 in f32 and f64, n = 256 with ``out_scalar`` (C0), on the
    tensor cores, beside ``torch.addmm`` of a sparse BSR; then phase 3's
    complex BSR (4000^2, bs 16, n = 64) in c128 and c64 on the tensor
    cores' complex instances, each beside ``torch.sparse.mm`` of a sparse
    BSR and the CUDA-core variant launched directly (``k1_simt``), and
    that variant's own row in c128, launched directly."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr

    n3, nc = SIZES["config3"], SIZES["complex"]
    for (bs, dt), a3 in inputs["bsrs"].items():
        A3 = formats.to_device(a3)
        lengths = np.diff(a3.indptr)
        plan = A3.bsr_plan()  # as dot_product passes it, built once
        args = (*A3.bsr_arrays(), cuda(inputs["b3"][dt]), None, 2.0,
                cuda(inputs["out3"][(bs, dt)]))
        flop = 2.0 * a3.nnz * 256
        row = timed_row(
            "K1_bsr_spmm_tc",
            f"config3 BSR bs={bs} {np.dtype(dt).name} {n3}x{n3} 5% blocks "
            f"@ ({n3},256), out_scalar=2",
            lambda: bsr.bsr_spmm(*args, plan=plan),
            lambda: bsr.bsr_spmm_plain(*args),
            bsr_bound(*args[:4], c0=args[6]),
            bsr_library(*args[:4], a3.shape, c0=args[6], beta=2.0),
            gflop=flop / 1e9, blocks_per_row_mean=float(lengths.mean()),
            blocks_per_row_max=int(lengths.max()), chunk=plan.chunk)
        row.update(tflops=flop / row["ms"] / 1e9,
                   plain_tflops=flop / row["plain_ms"] / 1e9)
        rows.append(row)
    # Phase 3's complex BSR on the tensor cores' complex instances in c128
    # and c64, each beside the CUDA-core variant launched directly (which
    # served complex values before them); then that variant's own row.
    for npdt in (np.complex128, np.complex64):
        Abc, bc = complex_bsr_operands(inputs, npdt)
        args = (*Abc.bsr_arrays(), bc)
        plan = Abc.bsr_plan()  # as dot_product passes it, built once
        shape = (f"BSR {np.dtype(npdt).name} bs=16 {nc}x{nc} 5% blocks "
                 f"@ ({nc},64)")
        flop = 8.0 * args[2].numel() * 64
        row = timed_row(
            "K1_bsr_spmm_tc_complex", shape,
            lambda: bsr.bsr_spmm(*args, plan=plan),
            lambda: bsr.bsr_spmm_plain(*args), bsr_bound(*args),
            bsr_library(*args, Abc.shape),
            beside={"cuda_core_variant": lambda: k1_simt(*args)},
            gflop=flop / 1e9, chunk=plan.chunk)
        row.update(tflops=flop / row["ms"] / 1e9)
        rows.append(row)
        if npdt == np.complex128:
            rows.append(timed_row(
                "K1_bsr_spmm_simt", shape + " (launched directly)",
                lambda: k1_simt(*args), lambda: bsr.bsr_spmm_plain(*args),
                bsr_bound(*args), bsr_library(*args, Abc.shape)))
        del Abc, args


def k7_rows(rows, inputs, rng):
    """K7's phase-4 rows: config 1 at n = 128 (f64; G of config 1's C,
    B phase 3's b1) and the 1M^2 SpMV matrix at n = 1 (the SpMV's value
    gradient; B its x), each beside ``torch.sparse.sampled_addmm`` and,
    in the same turns, the kernel that gathers the same rows of B for the
    same A (K2 with plan at config 1, K3 at n = 1).  Each row carries the
    gathered bytes (nnz * n * itemsize: every entry reads its row of B)
    and the rates they imply for K7 and that kernel."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import csr, sddmm

    n1, nv = SIZES["config1"], SIZES["spmv"]
    cases = (
        (f"config1 CSR f64 {n1}x{n1} 1%, G ({n1},128), B ({n1},128)",
         inputs["a1"], cuda(rng.standard_normal((n1, 128))),
         cuda(inputs["b1"]), "K2_csr_spmm"),
        (f"CSR f64 {nv}x{nv}, 10 per row, G ({nv},1), B = x ({nv},1)",
         inputs["av"], cuda(rng.standard_normal((nv, 1))),
         cuda(inputs["xv"][:, None]), "K3_csr_spmv"),
    )
    for shape, a, g, b, same in cases:
        A = formats.to_device(a)
        ip, ix, dv = A.csr_arrays()
        if same == "K2_csr_spmm":
            plan = A.csr_plan()
            same_fn = (lambda: csr.csr_spmm(ip, ix, dv, b, plan=plan))
        else:
            plan = A.csr_plan(spmv=True)
            same_fn = (lambda: csr.csr_spmv(ip, ix, dv, b[:, 0], plan=plan))
        row = timed_row(
            "K7_csr_sddmm", shape,
            lambda: sddmm.csr_sddmm(ip, ix, g, b),
            lambda: sddmm.csr_sddmm_plain(ip, ix, g, b),
            sddmm_bound(ip, ix, g, b), sddmm_library(ip, ix, g, b, A.shape),
            beside={same: same_fn},
            schedule=list(sddmm.sddmm_schedule(g.shape[1], g.dtype,
                                               ix.numel())))
        gathered = ix.numel() * g.shape[1] * g.element_size()
        row.update(gathered_bytes=gathered,
                   gathered_tb_per_s=gathered / row["ms"] / 1e9)
        row["beside"][same]["gathered_tb_per_s"] = (
            gathered / row["beside"][same]["ms"] / 1e9)
        rows.append(row)


def block_strips(indptr, indices, g, b, bs):
    """(G's block row, B's block row) of every stored block, gathered:
    the operands of K8's ``torch.bmm`` yardstick."""
    from sparse_dot_tpu_torch.formats import expand_indptr

    n = g.shape[1]
    rows = expand_indptr(indptr, indices.numel()).long()
    return (g.reshape(-1, bs, n)[rows].contiguous(),
            b.reshape(-1, bs, n)[indices.long()].contiguous())


def k8_bound(indptr, indices, g, b, bs):
    """K8's bound: the BSR's index arrays, the block rows of G and of B it
    names (each once) and the output; bs * bs multiply-adds per stored
    block and column, at the card's peak for the value type (as K1's
    bound: the tensor cores' rate, f64 MMA for f64 and c128, 3xTF32 for
    f32 and c64)."""
    nblocks, n = indices.numel(), g.shape[1]
    g_rows = int((indptr.long().diff() > 0).sum())
    panels = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices)
             + (g_rows + panels) * bs * n * g.element_size()
             + nblocks * bs * bs * g.element_size())
    flop = flops_per_product(g.dtype) * nblocks * bs * bs * n
    peak = peak_flops(g.dtype)
    return bound(moved, flop, peak)


def k8_simt(ip, ix, g, b, bs):
    """K8's CUDA-core variant (which served every type before the
    tensor-core variant, and complex values until they took the tensor
    cores too) launched directly on one G or, with a leading member
    dimension on ``g`` (B shared), a batch: timed beside the tensor-core
    variant, never called by the port in blocks of a multiple of 8."""
    from sparse_dot_tpu_torch.ops import _build

    members = g.shape[0] if g.dim() == 3 else 1
    nb = ix.numel()
    out = torch.empty((members, nb, bs, bs), dtype=g.dtype, device=g.device)
    dt, it = _build.type_codes(g, ip)
    strides = (g.shape[-2] * g.shape[-1], 0, nb * bs * bs) if members > 1 \
        else (0, 0, 0)
    _build.launch("sdt_bsr_sddmm_simt", dt, it, ip.data_ptr(),
                  ip.numel() - 1, ix.data_ptr(), nb, g.data_ptr(),
                  b.data_ptr(), out.data_ptr(), bs, g.shape[-1],
                  *_build.scalar_parts(None), members, *strides,
                  _build.stream_of(g))
    return out if members > 1 else out[0]


def k1_simt(ip, ix, data, b):
    """K1's CUDA-core variant (the port's first K1, which served complex
    values until they took the tensor cores too), launched directly for
    one block set or, with a leading member dimension on ``data`` (b
    shared), a batch: timed beside the tensor-core variant, never called
    by the port in blocks of a multiple of 8."""
    from sparse_dot_tpu_torch.ops import _build

    members = data.shape[0] if data.dim() == 4 else 1
    nbrows, bs, n = ip.numel() - 1, data.shape[-1], b.shape[-1]
    c = torch.empty((members, nbrows * bs, n), dtype=b.dtype,
                    device=b.device)
    dt, it = _build.type_codes(data, ip)
    strides = ((data[0].numel(), 0, 0, nbrows * bs * n) if members > 1
               else (0, 0, 0, 0))
    _build.launch("sdt_bsr_spmm_simt", dt, it, ip.data_ptr(), ix.data_ptr(),
                  data.data_ptr(), b.data_ptr(), None, c.data_ptr(), nbrows,
                  bs, n, *_build.scalar_parts(None),
                  *_build.scalar_parts(0.0), members, *strides,
                  _build.stream_of(b))
    return c if members > 1 else c[0]


def complex_bsr_operands(inputs, npdt):
    """Phase 3's complex BSR (4000^2, bs 16, 5% of blocks) and its b in
    the complex type ``npdt``, on the card: (container, b)."""
    from sparse_dot_tpu_torch import formats

    return (formats.to_device(inputs["abc"].astype(npdt)),
            cuda(inputs["bc"].astype(npdt)))


def k8_rows(rows, inputs, rng):
    """K8's phase-4 rows: config 3 (8192^2 BSR, bs 64, 5% of blocks) at
    n = 256 in f64 and f32 (G random, B phase 3's b3) on the tensor
    cores, beside the ``torch.bmm`` of the strips gathered beforehand (a
    yardstick: no single torch call computes K8's function, and the
    gather is not timed) and, in the same turns, the CUDA-core variant on
    the same operands (the kernel that served real values before the
    tensor-core variant); then phase 3's complex BSR (4000^2, bs 16) at
    n = 64 in c128 and c64 on the tensor cores' complex instances, each
    beside the same yardstick and the CUDA-core variant launched directly
    (``k8_simt``, which served complex values before them), and the
    CUDA-core variant's own row in c128, launched directly."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr

    n3 = SIZES["config3"]
    for dt in (np.float64, np.float32):
        A3 = formats.to_device(inputs["bsrs"][(64, dt)])
        ip, ix, _ = A3.bsr_arrays()
        g = cuda(values(rng, (n3, 256), dt))
        b = cuda(inputs["b3"][dt])
        gs, bp = block_strips(ip, ix, g, b, 64)
        bp = bp.conj_physical().mT
        rows.append(timed_row(
            "K8_bsr_sddmm_tc",
            f"config3 BSR bs=64 {np.dtype(dt).name} {n3}x{n3} 5% blocks, "
            f"G ({n3},256), B ({n3},256)",
            lambda: bsr.bsr_sddmm(ip, ix, g, b, 64),
            lambda: bsr.bsr_sddmm_plain(ip, ix, g, b, 64),
            k8_bound(ip, ix, g, b, 64),
            yardstick=(lambda: torch.bmm(gs, bp),
                       "torch.bmm of the stored blocks' strips of G and "
                       "B^H, gathered beforehand (TF32 off)"),
            beside={"cuda_core_variant": lambda: k8_simt(ip, ix, g, b, 64)},
            nblocks=int(ix.numel()),
            device_match="bsr_sddmm"))
        del A3, gs, bp
    nc = SIZES["complex"]
    for npdt in (np.complex128, np.complex64):
        Ac, b = complex_bsr_operands(inputs, npdt)
        ip, ix, _ = Ac.bsr_arrays()
        g = cuda(values(rng, (nc, 64), npdt))
        gs, bp = block_strips(ip, ix, g, b, 16)
        bp = bp.conj_physical().mT
        name = np.dtype(npdt).name
        shape = f"BSR bs=16 {name} {nc}x{nc} 5% blocks, G ({nc},64), " \
                f"B ({nc},64)"
        yardstick = (lambda: torch.bmm(gs, bp),
                     "torch.bmm of the stored blocks' strips of G and B^H, "
                     "gathered beforehand")
        rows.append(timed_row(
            "K8_bsr_sddmm_tc_complex", shape,
            lambda: bsr.bsr_sddmm(ip, ix, g, b, 16),
            lambda: bsr.bsr_sddmm_plain(ip, ix, g, b, 16),
            k8_bound(ip, ix, g, b, 16), yardstick=yardstick,
            beside={"cuda_core_variant": lambda: k8_simt(ip, ix, g, b, 16)},
            nblocks=int(ix.numel()), device_match="bsr_sddmm"))
        if npdt == np.complex128:
            rows.append(timed_row(
                "K8_bsr_sddmm_simt", shape + " (launched directly)",
                lambda: k8_simt(ip, ix, g, b, 16),
                lambda: bsr.bsr_sddmm_plain(ip, ix, g, b, 16),
                k8_bound(ip, ix, g, b, 16), yardstick=yardstick,
                nblocks=int(ix.numel())))
        del Ac, g, b, gs, bp


def members_of(t, core):
    """The members that read operand ``t`` of ``core`` dimensions a
    batched call: B with a member dimension, else 1 (shared)."""
    return t.shape[0] if t.dim() > core else 1


def csr_batched_bound(indptr, indices, data, b, size):
    """``csr_bound`` of a batched K2 call of ``size`` members: the index
    arrays once, each member's values and named rows of b (once for a
    shared operand), ``size`` outputs; ``size`` times the multiply-adds."""
    n = b.shape[-1]
    rows = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices, data)
             + members_of(b, 2) * rows * n * b.element_size()
             + size * (indptr.numel() - 1) * n * b.element_size())
    flop = size * flops_per_product(b.dtype) * indices.numel() * n
    return bound(moved, flop, peak_flops(b.dtype))


def sddmm_batched_bound(indptr, indices, g, b, size):
    """``sddmm_bound`` of a batched K7 call of ``size`` members."""
    n = g.shape[-1]
    rows = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices, g)
             + members_of(b, 2) * rows * n * b.element_size()
             + size * indices.numel() * g.element_size())
    flop = size * flops_per_product(g.dtype) * indices.numel() * n
    return bound(moved, flop, peak_flops(g.dtype))


def bsr_batched_bound(indptr, indices, data, b, size):
    """``bsr_bound`` of a batched K1 call of ``size`` members."""
    bs, n = data.shape[-1], b.shape[-1]
    nblocks = indices.numel()
    panels = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices, data)
             + members_of(b, 2) * panels * bs * n * b.element_size()
             + size * (indptr.numel() - 1) * bs * n * b.element_size())
    flop = size * flops_per_product(b.dtype) * nblocks * bs * bs * n
    peak = peak_flops(b.dtype)
    return bound(moved, flop, peak)


def k8_batched_bound(indptr, indices, g, b, bs, size):
    """``k8_bound`` of a batched K8 call of ``size`` members."""
    nblocks, n = indices.numel(), g.shape[-1]
    g_rows = int((indptr.long().diff() > 0).sum())
    panels = int(torch.unique(indices).numel())
    moved = (nbytes(indptr, indices)
             + (members_of(g, 2) * g_rows + members_of(b, 2) * panels)
             * bs * n * g.element_size()
             + size * nblocks * bs * bs * g.element_size())
    flop = size * flops_per_product(g.dtype) * nblocks * bs * bs * n
    peak = peak_flops(g.dtype)
    return bound(moved, flop, peak)


def batched_coo_library(indptr, indices, data, b, shape):
    """The batched K2's one torch call: ``torch.bmm`` of the members as
    one batched sparse COO (B, m, k) (cuSPARSE) and b expanded to (B, k,
    n) beforehand."""
    from sparse_dot_tpu_torch.formats import expand_indptr

    def make():
        size, nnz = data.shape
        rows = expand_indptr(indptr, nnz).long()
        member = torch.arange(size, device=data.device).repeat_interleave(nnz)
        ids = torch.stack([member, rows.repeat(size),
                           indices.long().repeat(size)])
        a = torch.sparse_coo_tensor(ids, data.reshape(-1), (size, *shape))
        a = a.coalesce()
        bb = (b if b.dim() == 3 else b.expand(size, *b.shape)).contiguous()
        return ((lambda: torch.bmm(a, bb)),
                "torch.bmm(A_coo (B, m, k), B (B, k, n)) (cuSPARSE)")
    return library_call(make)


def batched_sddmm_library(indptr, indices, g, b, shape):
    """The batched K7's one torch call: ``torch.sparse.sampled_addmm`` at a
    batched CSR (B, m, k) of A's pattern (cuSPARSE batched SDDMM), G
    (B, m, n) and B^T (B, n, k), beta = 0."""
    def make():
        size = g.shape[0]
        a = torch.sparse_csr_tensor(
            indptr.expand(size, -1).contiguous(),
            indices.expand(size, -1).contiguous(),
            torch.zeros((size, indices.numel()), dtype=g.dtype,
                        device=g.device), size=(size, *shape))
        bt = (b if b.dim() == 3 else b.expand(size, *b.shape)).mT
        return ((lambda: torch.sparse.sampled_addmm(a, g, bt, beta=0.0)),
                "torch.sparse.sampled_addmm(A_csr (B, m, k), G, B^T, "
                "beta=0) (cuSPARSE batched SDDMM)")
    return library_call(make)


def k7_batched_rows(rows, inputs, rng):
    """Batched K7's phase-4 rows at config 1 (f64, n = 128), each beside
    the same members' single launches in the same turns: 4 and 16 (G, B)
    pairs (the per-sample gradients' launch) beside batched-CSR
    ``torch.sparse.sampled_addmm``; 16 G's with B shared (jacrev's
    cotangents) and 16 B's with G shared (a batched tangent), each through
    ``CsrSddmm`` as the ``vmap`` rules call it, beside ``sampled_addmm``
    given the shared operand expanded into a copy."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import autograd, sddmm

    n1 = SIZES["config1"]
    A1 = formats.to_device(inputs["a1"])
    ip, ix, _ = A1.csr_arrays()
    pattern = formats.CsrPattern(ip, ix, n1)
    nnz = ix.numel()
    for size in (4, 16):
        g = cuda(values(rng, (size, n1, 128), np.float64))
        bb = cuda(values(rng, (size, n1, 128), np.float64))
        rows.append(timed_row(
            "K7_csr_sddmm",
            f"batched: config1 CSR f64 {n1}x{n1} 1%, {size} (G, B) pairs "
            f"of ({n1},128)",
            lambda: sddmm.sddmm_batched(ip, ix, g, bb),
            lambda: sddmm.csr_sddmm_batched_plain(ip, ix, g, bb),
            sddmm_batched_bound(ip, ix, g, bb, size),
            batched_sddmm_library(ip, ix, g, bb, A1.shape),
            beside={f"{size}_single_launches": lambda: [
                sddmm.csr_sddmm(ip, ix, g[i], bb[i]) for i in range(size)]},
            members=size,
            schedule=list(sddmm.sddmm_schedule(128, g.dtype,
                                               size * nnz))))
        if size == 16:
            break
        del g, bb
    b0, g0 = bb[0], g[0]
    for label, gs, bs, shared in (("16 G's of (10000,128), B shared", g, b0,
                                   "b"),
                                  ("16 B's of (10000,128), G shared", g0,
                                   bb, "g")):
        copied = (bs.expand(16, -1, -1).contiguous() if shared == "b"
                  else bs)
        g_lib = (gs.expand(16, -1, -1).contiguous() if shared == "g"
                 else gs)
        row = timed_row(
            "K7_csr_sddmm",
            f"batched: config1 CSR f64 {n1}x{n1} 1%, {label}",
            lambda gs=gs, bs=bs: autograd.CsrSddmm.apply(pattern, gs, bs,
                                                         None),
            lambda gs=gs, bs=bs: sddmm.csr_sddmm_batched_plain(ip, ix, gs,
                                                               bs),
            sddmm_batched_bound(ip, ix, gs, bs, 16),
            batched_sddmm_library(ip, ix, g_lib, copied, A1.shape),
            beside={"16_single_launches": (
                lambda: [sddmm.csr_sddmm(ip, ix, g[i], b0)
                         for i in range(16)]) if shared == "b" else (
                lambda: [sddmm.csr_sddmm(ip, ix, g0, bb[i])
                         for i in range(16)])},
            members=16, shared=shared)
        # The schedule of the launch: G shared runs on A's transpose with
        # the roles swapped, so B is the operand shared there.
        s, members = sddmm.batched_schedule(128, g.dtype, nnz, 16,
                                            (n1 * 128, 0))
        row["schedule"], row["members_a_group"] = list(s), members
        rows.append(row)
        del copied, g_lib
    del g, bb


def bsr_batched_rows(rows, inputs, rng):
    """``batched_rows``' rows of K1 and K8: config 3 (bs 64, f64, n = 256;
    K1 also in f32) and phase 3's complex BSR (c128, bs 16, n = 64), 4
    block sets with b shared (K8: 4 G's, B shared), each beside the same
    members' single launches and a yardstick made once a member, config
    3's K1 also beside the per-member instance (``k1_batched_at``), the
    complex ones beside the CUDA-core variant's batched launch
    (``k1_simt``, ``k8_simt``)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr

    for key, n, label in (((64, np.float64), 256, "config3"),
                          ((64, np.float32), 256, "config3"),
                          (None, 64, "complex")):
        a = inputs["bsrs"][key] if key else inputs["abc"]
        A = formats.to_device(a)
        bp, bx, _ = A.bsr_arrays()
        bs = a.blocksize[0]
        npdt = a.dtype.type
        tdt = torch.from_numpy(np.zeros(0, npdt)).dtype
        b = cuda(inputs["b3"][key[1]] if key else inputs["bc"])
        kplan = A.bsr_plan()
        blocks_ = cuda(values(rng, (4, *a.data.shape), npdt,
                              1.0 / np.sqrt(bs * 20)))
        side = a.shape[0]
        mats = [torch.sparse_bsr_tensor(bp, bx, blocks_[i], size=a.shape)
                for i in range(4)]
        # The complex rows also time the CUDA-core variant launched
        # directly (which served them before) in the same turns.
        k1_beside = {"4_single_launches": lambda: [
            bsr.bsr_spmm(bp, bx, blocks_[i], b, plan=kplan)
            for i in range(4)]}
        if not key:
            k1_beside["cuda_core_variant"] = lambda: k1_simt(bp, bx, blocks_,
                                                             b)
        else:
            k1_beside["per_member_instance"] = lambda: k1_batched_at(
                bp, bx, blocks_, b, kplan, 1)
        rows.append(timed_row(
            variant_name("K1_bsr_spmm", tdt, bs),
            f"batched: {label} BSR bs={bs} {np.dtype(npdt).name} "
            f"{side}x{side} 5% blocks, 4 block sets @ ({side},{n}) shared",
            lambda: bsr.spmm_batched(bp, bx, blocks_, b, plan=kplan),
            lambda: bsr.bsr_spmm_batched_plain(bp, bx, blocks_, b),
            bsr_batched_bound(bp, bx, blocks_, b, 4),
            yardstick=(lambda: torch.stack([torch.sparse.mm(mat, b)
                                            for mat in mats]),
                       "4 x torch.sparse.mm(A_bsr, B), one a member"),
            beside=k1_beside, members=4,
            group=bsr.spmm_group(tdt, bs, 4)))
        if key == (64, np.float32):  # K8's f32 batched row is not kept
            del A, blocks_, mats
            continue
        g = cuda(values(rng, (4, side, n), npdt))
        strips = [block_strips(bp, bx, g[i], b, bs) for i in range(4)]
        panels = strips[0][1].conj_physical().mT
        k8_beside = {"4_single_launches": lambda: [
            bsr.bsr_sddmm(bp, bx, g[i], b, bs) for i in range(4)]}
        if not key:
            k8_beside["cuda_core_variant"] = lambda: k8_simt(bp, bx, g, b, bs)
        rows.append(timed_row(
            variant_name("K8_bsr_sddmm", tdt, bs),
            f"batched: {label} BSR bs={bs} {np.dtype(npdt).name} "
            f"{side}x{side} 5% blocks, 4 G's ({side},{n}), B shared",
            lambda: bsr.sddmm_batched(bp, bx, g, b, bs),
            lambda: bsr.bsr_sddmm_batched_plain(bp, bx, g, b, bs),
            k8_batched_bound(bp, bx, g, b, bs, 4),
            yardstick=(lambda: torch.stack([torch.bmm(gs, panels)
                                            for gs, _ in strips]),
                       "4 x torch.bmm of the stored blocks' strips of G "
                       "and B^H, gathered beforehand, one a member"),
            beside=k8_beside, members=4, device_match="bsr_sddmm"))
        del A, blocks_, mats, g, strips, panels


def k2_batched_at(ip, ix, data, b, plan, group):
    """K2's batched launch of ``data``'s members, b shared, at ``group``
    members a block (1: the per-member instance, as the parent ran such a
    batch), as ``csr.spmm_batched`` makes it (``csr._launch_k2``): for
    phase 4's rows and ``compare_k7_k13.py``'s sweeps of the group."""
    from sparse_dot_tpu_torch.ops import csr

    size, nnz = data.shape
    m, n = ip.numel() - 1, b.shape[-1]
    c = torch.empty((size, m, n), dtype=b.dtype, device=b.device)
    s = csr.spmm_schedule(n, b.dtype, nnz / m, csr.aligned_members(
        (b, 0), (c, m * n)))
    counts = work = None
    if plan.slots:
        counts = torch.zeros((size, plan.slots), dtype=torch.int32,
                             device=b.device)
        work = torch.empty((size, plan.slots, n), dtype=b.dtype,
                           device=b.device)
    csr._launch_k2(ip, ix, plan, s, None, None, False, size,
                   (data.stride(0), 0, 0, m * n), data.data_ptr(),
                   b.data_ptr(), None, c.data_ptr(),
                   None if work is None else work.data_ptr(),
                   None if counts is None else counts.data_ptr(), data, b,
                   group)
    return c


def batched_rows(rows, inputs, rng):
    """Phase 4's rows of the batched launches, each beside the same
    members' single launches (one a member) in the same turns: K2 at
    config 1 (f64, n = 128) over 4 and 16 value sets with b shared,
    beside ``torch.bmm`` of a batched sparse COO; K2 at n = 1 on the 1M^2
    SpMV matrix over 4 value sets (``CsrSpmv``'s vmap over the values),
    beside 4 K3 launches; K7's (``k7_batched_rows``); K1 and K8 at
    config 3 (bs 64, f64, n
    = 256) over 4 block sets (K8: 4 G's, B shared) and at the complex BSR
    (c128, bs 16, n = 64, the tensor cores' complex instances, beside the
    CUDA-core variant's batched launch too), each beside its existing
    row's yardstick made once a member (K1: ``torch.sparse.mm`` of a
    sparse BSR, K8: ``torch.bmm`` of the strips gathered beforehand)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr, csr

    n1, n3, nc = SIZES["config1"], SIZES["config3"], SIZES["complex"]
    nv = SIZES["spmv"]
    A1 = formats.to_device(inputs["a1"])
    ip, ix, _ = A1.csr_arrays()
    plan = A1.csr_plan()
    b1 = cuda(inputs["b1"])
    for size in (4, 16):
        data = cuda(values(rng, (size, ix.numel()), np.float64, 0.1))
        rows.append(timed_row(
            "K2_csr_spmm",
            f"batched: config1 CSR f64 {n1}x{n1} 1%, {size} value sets "
            f"@ ({n1},128) shared",
            lambda: csr.spmm_batched(ip, ix, data, b1, plan=plan),
            lambda: csr.csr_spmm_batched_plain(ip, ix, data, b1),
            csr_batched_bound(ip, ix, data, b1, size),
            batched_coo_library(ip, ix, data, b1, A1.shape),
            beside={f"{size}_single_launches": lambda: [
                csr.csr_spmm(ip, ix, data[i], b1, plan=plan)
                for i in range(size)],
                "per_member_instance": lambda: k2_batched_at(
                    ip, ix, data, b1, plan, 1)},
            device_match="csr_spmm_kernel", members=size,
            group=csr.batched_plan(128, b1.dtype, ix.numel() / n1, True,
                                   ix.element_size(), size, True, True)[1]))
        del data
    k7_batched_rows(rows, inputs, rng)
    Av = formats.to_device(inputs["av"])
    vp, vx, _ = Av.csr_arrays()
    x = cuda(inputs["xv"])
    data = cuda(values(rng, (4, vx.numel()), np.float64, 0.3))
    plan_v, plan_k3 = Av.csr_plan(), Av.csr_plan(spmv=True)
    rows.append(timed_row(
        "K2_csr_spmm",
        f"batched: CSR f64 {nv}x{nv}, 10 per row, 4 value sets @ ({nv},1) "
        "shared (CsrSpmv's vmap over the values)",
        lambda: csr.spmm_batched(vp, vx, data, x[:, None], plan=plan_v),
        lambda: csr.csr_spmm_batched_plain(vp, vx, data, x[:, None]),
        csr_batched_bound(vp, vx, data, x[:, None], 4),
        batched_coo_library(vp, vx, data, x[:, None], Av.shape),
        beside={"4_k3_launches": lambda: [
            csr.csr_spmv(vp, vx, data[i], x, plan=plan_k3)
            for i in range(4)],
            "per_member_instance": lambda: k2_batched_at(
                vp, vx, data, x[:, None], plan_v, 1)},
        device_match=("csr_spmm_kernel", "csr_spmv_kernel"), members=4,
        group=csr.batched_plan(1, x.dtype, vx.numel() / nv, True,
                               vx.element_size(), 4, True, True)[1]))
    del data, Av
    bsr_batched_rows(rows, inputs, rng)
    for row in rows:
        if row["shape"].startswith("batched:"):
            single = next(v for k, v in row["beside"].items()
                          if k.endswith(("_single_launches", "_k3_launches")))
            row["ms_over_single_launches"] = row["ms"] / single["ms"]
            if "per_member_instance" in row["beside"]:
                row["ms_over_per_member_instance"] = (
                    row["ms"] / row["beside"]["per_member_instance"]["ms"])


def k9_work(ip, ix, y_ip, transposed):
    """(products, rows of Y named, entries of those rows) of K9 over P =
    (ip, ix) and Y's indptr: each entry of P walks its row of Y."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    _, q = spgemm_grad.entry_ids(ip, ix, transposed)
    y_len = y_ip.long().diff()
    named = torch.unique(q.long())
    return (int(y_len[q.long()].sum()), int(named.numel()),
            int(y_len[named].sum()))


def k9_bound(ip, ix, d, y_ip, y_ix, y_dv, transposed):
    """K9's bound and products: P's index arrays, the lines of D its
    entries name (rows in the dA form, columns in the dB form; each
    once), the rows of Y they name (each once) and the output; one
    multiply-add per product, on the CUDA cores."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    products, y_rows, y_entries = k9_work(ip, ix, y_ip, transposed)
    line, _ = spgemm_grad.entry_ids(ip, ix, transposed)
    d_lines = int(torch.unique(line.long()).numel())
    line_len = d.shape[0] if transposed else d.shape[1]
    moved = (nbytes(ip, ix) + d_lines * line_len * d.element_size()
             + 2 * y_rows * y_ip.element_size()
             + y_entries * (y_ix.element_size() + y_dv.element_size())
             + ix.numel() * d.element_size())
    flop = flops_per_product(d.dtype) * products
    return bound(moved, flop, peak_flops(d.dtype)), products


def k9_yardstick(p_arrays, d, y_arrays, shapes, transposed):
    """K9's function the way torch has one: Y densified (``to_dense``)
    and ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) of D and conj(Y)^T
    at P's pattern, beta = 0; for the dB form of conj(Y) and D.  ``d`` is
    D, or a function that makes it in each call.  A yardstick: the port
    never calls it."""
    (ip, ix), (y_ip, y_ix, y_dv) = p_arrays, y_arrays
    p_shape, y_shape = shapes
    zeros = torch.zeros(ix.numel(), dtype=y_dv.dtype, device=y_dv.device)
    p = torch.sparse_csr_tensor(ip, ix, zeros, size=p_shape)
    y = torch.sparse_csr_tensor(y_ip, y_ix, y_dv, size=y_shape)

    def run():
        dense = d() if callable(d) else d
        yc = y.to_dense().conj_physical()
        if transposed:
            return torch.sparse.sampled_addmm(p, yc, dense,
                                              beta=0.0).values()
        return torch.sparse.sampled_addmm(p, dense, yc.mT,
                                          beta=0.0).values()

    return run, ("Y densified + torch.sparse.sampled_addmm at P's pattern "
                 "(cuSPARSE SDDMM), beta = 0")


def k9_rows(inp):
    """K9's phase-4 rows: the value gradients of case a (the demo X @ X.T;
    dA: P = X, D = G, Y = X^T; dB: P = X^T, D = G, Y = op(A)^T) and case
    d (config 3's BSR x BSR as CSR), G random, each beside
    ``k9_yardstick`` and, for dB, in the same turns, the copy of G^T that
    a backward without the dB form makes before K9
    (``g.mT.contiguous()``); the plan and the number of runs with each
    row."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm_grad

    rng = np.random.default_rng(SEED + 12)
    rows = []
    x = inp["x"]
    d_shape = "config3 BSR bs=64 8192^2 5% blocks f64 as CSR, A @ B, "
    cases = (("a-dA", "demo X @ X.T, dL/dA at X's pattern", x, x.T, False,
              REPS),
             ("a-dB", "demo X @ X.T, dL/dB at X.T's pattern", x, x.T, True,
              REPS),
             ("d-dA", d_shape + "dL/dA", inp["bsr_a"], inp["bsr_b"], False,
              REPS_CONFIG3),
             ("d-dB", d_shape + "dL/dB", inp["bsr_a"], inp["bsr_b"], True,
              REPS_CONFIG3))
    for case, shape, a, b, transposed, reps in cases:
        A, B = formats.to_device(a), formats.to_device(b)
        a_ip, a_ix, a_dv = A.csr_arrays()
        b_ip, b_ix, b_dv = B.csr_arrays()
        g = cuda(values(rng, (a.shape[0], b.shape[1]), np.float64))
        beside = {}
        if transposed:
            t, order = formats.CsrPattern(a_ip, a_ix, a.shape[1]).transpose()
            args = (b_ip, b_ix, g, t.indptr, t.indices, a_dv[order], None,
                    True)
            shapes = (b.shape, t.shape)
            beside["gt_copy"] = lambda: g.mT.contiguous()
        else:
            args = (a_ip, a_ix, g, b_ip, b_ix, b_dv, None, False)
            shapes = (a.shape, b.shape)

        (bound_ms, bound_by), products = k9_bound(*args[:6], transposed)
        plan = k9_plan(g, args[3], args[4], transposed)
        row = timed_row(
            "K9_csr_spgemm_sddmm", shape,
            lambda: spgemm_grad.csr_spgemm_sddmm(*args),
            lambda: spgemm_grad.csr_spgemm_sddmm_plain(*args),
            (bound_ms, bound_by), reps=reps,
            yardstick=k9_yardstick(args[:2], args[2], args[3:6], shapes,
                                   transposed),
            beside=beside, case=case, products=products,
            plan=plan._asdict(),
            device_match="sampled_kernel")
        row["gproducts_per_s"] = products / row["ms"] / 1e6
        row["runs"] = k9_runs(args, plan)
        rows.append(row)
        del A, B, args, beside
        torch.cuda.empty_cache()
    return rows


def k11_bound(a, b, c, g, transposed):
    """K11's bound and products for op(A) = ``a``, op(B) = ``b`` (their
    CSR arrays) and G on C's pattern ``c``: the bytes of P's structure,
    Y's arrays (op(B), or op(A)^T in the dB form), C's structure, G and
    the output, each once; one multiply-add per product of op(A) op(B)
    that lands in C (all of them but j < i under ``triangular``), on the
    CUDA cores."""
    products = int(b[0].long().diff()[a[1].long()].sum())
    p, y = (b, a) if transposed else (a, b)
    moved = (nbytes(p[0], p[1], *y, *c, g)
             + p[1].numel() * g.element_size())
    flop = flops_per_product(g.dtype) * products
    return bound(moved, flop, peak_flops(g.dtype)), products


def k11_yardsticks(a, b, c, g, shapes, transposed):
    """At case a: K11's function the way torch has one, G densified and
    ``k9_yardstick`` (Y densified and ``torch.sparse.sampled_addmm``) in
    each call; and K9 on G densified beforehand, timed beside.  Neither
    is called by the port."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm_grad

    a_shape, b_shape = shapes
    g_csr = torch.sparse_csr_tensor(*c, g, size=(a_shape[0], b_shape[1]))
    gd = g_csr.to_dense()
    if transposed:
        t, order = formats.CsrPattern(a[0], a[1], a_shape[1]).transpose()
        p, y, y_shapes = b, (t.indptr, t.indices, a[2][order]), (b_shape,
                                                                 t.shape)
    else:
        p, y, y_shapes = a, b, (a_shape, b_shape)
    run, note = k9_yardstick(p[:2], g_csr.to_dense, y, y_shapes, transposed)
    return ((run, "G densified + " + note),
            {"k9_on_g_densified": lambda: spgemm_grad.csr_spgemm_sddmm(
                *p[:2], gd, *y, None, transposed)})


def k11_rows(inp):
    """K11's phase-4 rows: the value gradients of case a (the demo X @
    X.T, sparse output) and case c (the 1M^2 A @ A), dL/dA and dL/dB, G
    random on C's pattern (f64): median, p10 and p90 of 25 (of 5 where a
    call of the kernel or its plain version takes over 50 ms), the bound
    by ``k11_bound``, products per second, the kernel's profiler time
    (``device_ms``); beside it in the same turns the call as
    ``CsrSpgemmSparseSddmm`` makes it (``function``: the operands'
    patterns given, C's column span known, so no host read), and at case
    a ``k11_yardsticks``.  No torch call computes it."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import autograd, spgemm, spgemm_grad

    rng = np.random.default_rng(SEED + 18)
    rows = []
    x = inp["x"]
    cases = (("a", "demo X @ X.T, X 500x5000 CSR 21.2% f64, sparse output",
              x, x.T.tocsr()),
             ("c", "1M x 1M CSR, 2M random nnz, A @ A, f64, sparse output",
              inp["a1m"], inp["a1m"]))
    for case, shape, a_np, b_np in cases:
        A, B = formats.to_device(a_np), formats.to_device(b_np)
        a, b = A.csr_arrays(), B.csr_arrays()
        n = b_np.shape[1]
        c = spgemm.csr_spgemm(*a, *b, n)[:2]
        g = cuda(values(rng, c[1].numel(), np.float64))
        pa = autograd.patterns.get(a[0], a[1], b[0].numel() - 1)
        pb = autograd.patterns.get(b[0], b[1], n)
        for transposed in (False, True):
            args = (*a, *b, *c, g, n, transposed)
            kernel_fn = (lambda args=args:
                         spgemm_grad.csr_spgemm_sparse_sddmm(*args))
            plain_fn = (lambda args=args:
                        spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args))
            first = max(t[0] for t in time_turns(
                {"kernel": kernel_fn, "plain": plain_fn}, 1).values())
            reps = REPS if first <= 50 else 5
            (bound_ms, bound_by), products = k11_bound(a, b, c, g,
                                                       transposed)
            yardstick, beside = (k11_yardsticks(
                a, b, c, g, (a_np.shape, b_np.shape), transposed)
                if case == "a" else (None, {}))
            beside["function"] = (
                lambda args=args: spgemm_grad.sparse_sampled(
                    *args, a=pa, b=pb, c=formats.CsrPattern(
                        c[0], c[1], n, span=(0, n))))
            plan = k11_plan(a, b, g, n, transposed)
            form = "dL/dB at B's pattern" if transposed else \
                "dL/dA at A's pattern"
            row = timed_row(
                "K11_csr_spgemm_sparse_sddmm", f"{shape}, {form}",
                kernel_fn, plain_fn, (bound_ms, bound_by),
                (None, "none: torch has no sampled product of two sparse "
                       "operands at a sparse pattern"),
                reps=reps, yardstick=yardstick, beside=beside,
                device_match=K11_DEVICE_NAMES,
                case=f"{case}-{'dB' if transposed else 'dA'}",
                products=products, c_nnz=int(c[1].numel()),
                plan=plan._asdict(),
                runs=k11_runs(pb if transposed else pa, transposed))
            row["gproducts_per_s"] = products / row["ms"] / 1e6
            rows.append(row)
        del A, B, a, b, c, g, pa, pb
        autograd.patterns.clear()
        torch.cuda.empty_cache()
    return rows


# Kernel names in a profiler trace: K11's in place, and K9's, which K11
# runs where it stages lines and which is timed beside K11 at case a.
K11_DEVICE_NAMES = ("sparse_in_place_kernel", "sampled_kernel",
                    "sampled_group_kernel")
# K9's kernels in a trace: the per-member one and a member group's.
K9_DEVICE_NAMES = ("sampled_kernel", "sampled_group_kernel")
# PyTorch's gathers (``t[index]``), which a batched K9 or K11 call runs
# before its launch: Y's values into bank order for a member group, the
# dB form's op(A)^T values; counted in the batched rows' device times.
GATHER_NAMES = ("index", "gather")


def k11_runs(pattern, transposed):
    """The number of runs and of work items K11's single launch cached on
    P's ``pattern``, or None where its lines were read in place."""
    for key, runs in pattern.plans.items():
        if key[:2] == ("k11", transposed) and key[-1] == 1:
            return {"runs": runs.run_q.numel(),
                    "items": runs.items.numel() - 1, "chunk": runs.chunk}
    return None


def k9_runs(args, plan):
    """The number of runs and of work items K9 cached for ``args``."""
    from sparse_dot_tpu_torch.ops import autograd

    for *_, pattern in autograd.patterns.entries:
        if pattern.indices is args[1]:
            for key, runs in pattern.plans.items():
                if key[:3] == ("k9", args[7], plan.panel) and key[-1] == 1:
                    return {"runs": runs.run_q.numel(),
                            "items": runs.items.numel() - 1,
                            "chunk": runs.chunk}
    return None


# Case d's plain versions expand 1.4 G products in chunks; fewer turns.
REPS_CONFIG3 = 5


def product_steps(args, reps=REPS):
    """The steps of ``csr_spgemm`` at one case (``spgemm.PRODUCT_STEPS``:
    the plan and K4 in one launch, the counts' running sum, the nnz read,
    which is the one host sync, and K5 with its wrapper), marked by its
    ``marks`` hook: per
    step the device span between CUDA events recorded as each step ends
    (K5's includes its wrapper's host time, for the card is idle after the
    sync) and the host clock; median (p10, p90) of ``reps``, each after a
    1 GiB read (L2 evicted; the card busy while the plan is issued).  The
    result is checked against a call without marks."""
    from sparse_dot_tpu_torch.ops import spgemm

    names = spgemm.PRODUCT_STEPS
    flush = torch.ones(256 << 20, dtype=torch.float32, device="cuda")
    device = {name: [] for name in names + ("total",)}
    host = {name: [] for name in names + ("total",)}
    for _ in range(reps + 1):  # the first is a warm-up
        flush.sum()
        events, clock, seen = [], [], []

        def mark(step):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            clock.append(time.perf_counter())
            seen.append(step)

        mark("start")
        out = spgemm.csr_spgemm(*args, marks=mark)
        events[-1].synchronize()
        if tuple(seen[1:]) != names:
            raise AssertionError(f"csr_spgemm marked {seen[1:]}")
        for s, name in enumerate(names):
            device[name].append(events[s].elapsed_time(events[s + 1]))
            host[name].append((clock[s + 1] - clock[s]) * 1e3)
        device["total"].append(events[0].elapsed_time(events[-1]))
        host["total"].append((clock[-1] - clock[0]) * 1e3)
    whole = spgemm.csr_spgemm(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(whole, out)):
        raise AssertionError("the marked product differs")
    return {"device_ms": {k: spread(v[1:]) for k, v in device.items()},
            "host_ms": {k: spread(v[1:]) for k, v in host.items()},
            "reps": reps}


def poisson_square(side, mean_row, seed=SEED + 42):
    """side x side CSR, f64, with Poisson(``mean_row``) entries a row at
    random columns, repeats summed (``random_csr``'s recipe): its A @ A
    holds about mean_row^2 products a row."""
    indptr, indices, data = random_csr(np.random.default_rng(seed), side,
                                       side, mean_row, np.float64)
    a = sps.csr_matrix((data, indices, indptr), shape=(side, side))
    a.sum_duplicates()
    return a


def spgemm_cases(inp):
    """K4's and K5's phase-4 cases: {case: (shape, A, B, reps)}.  a: the
    demo X @ X.T (dense rows); c: the 1M^2 A @ A (register bins); d:
    config 3's BSR x BSR (dense rows); h: 100,000^2, Poisson(10) a row,
    A @ A (about 100 products a row: the sorted-product bins); hb:
    50,000^2, Poisson(30) a row, A @ A (about 900 a row: the hash
    tables of a block)."""
    x = inp["x"]
    h = poisson_square(100_000, 10)
    hb = poisson_square(50_000, 30, SEED + 43)
    return {
        "a": ("demo X @ X.T, X 500x5000 CSR 21.2% f64", x, x.T, REPS),
        "c": ("1M x 1M CSR, 2M random nnz, A @ A, f64", inp["a1m"],
              inp["a1m"], REPS),
        "d": ("config3 BSR bs=64 8192^2 5% blocks f64, A @ B", inp["bsr_a"],
              inp["bsr_b"], REPS_CONFIG3),
        "h": ("100k x 100k CSR, Poisson(10) a row, A @ A, f64", h, h, REPS),
        "hb": ("50k x 50k CSR, Poisson(30) a row, A @ A, f64", hb, hb,
               REPS_CONFIG3),
    }


def bin_rows(plan, sizes):
    """{"kind:slots": rows} of a K4/K5 plan's bins that hold rows."""
    return {f"{int(kind)}:{int(slots)}": int(r)
            for (kind, slots, _), r in zip(plan.bins, sizes) if r}


def bin_groups(plan, sizes, groups):
    """{"kind:slots": [rows, members a block]} of the bins that hold rows
    in a batched K5 launch of ``groups`` (``spgemm.fill_groups``)."""
    return {f"{int(kind)}:{int(slots)}": [int(r), int(g)]
            for (kind, slots, _), r, g in zip(plan.bins, sizes, groups) if r}


def spgemm_timings(inp):
    """K4 (count), K5 (fill) and K4 + K5 as one product (plan, count,
    running sum, the nnz read, fill) against their plain versions, at
    ``spgemm_cases``' cases a, c, d, h and hb, products/s and the rows
    of each bin beside each; K6 as ``k6_timings`` times it; then the wall
    time of ``dot_product(X, X.T)`` host in to host out, next to
    scipy's."""
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    rows, steps = [], {}
    x = inp["x"]
    for case, (shape, a, b, reps) in spgemm_cases(inp).items():
        A, B = formats.to_device(a), formats.to_device(b)
        args = (*A.csr_arrays(), *B.csr_arrays(), b.shape[1])
        ip, ix, dv, bip, bix, bdv, n = args
        plan = spgemm.spgemm_plan(ip, ix, bip, n, dv.dtype, ip.dtype)
        products = int(plan.ub.sum())
        whole = spgemm.csr_spgemm(*args)
        ref = spgemm.spgemm_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(whole[0], ref[0])
                and torch.equal(whole[1], ref[1])):
            raise AssertionError(f"case {case}: K4/K5 pattern differs")
        nnz = int(whole[0][-1])
        # K5 as csr_spgemm launches it: the bin sizes read with nnz.
        sizes = plan.offsets.diff().tolist()
        # Bytes: A's arrays, the rows of B that A names (each once), and
        # the output; FLOPs: one multiply-add per product.  K4 counts with
        # integer work only, so bytes bound it.
        named = torch.unique(ix.long())
        b_len = (bip[1:] - bip[:-1]).long()[named]
        b_moved = int(b_len.sum()) * (bix.element_size()
                                      + bdv.element_size()) \
            + 2 * named.numel() * bip.element_size()
        b_index = int(b_len.sum()) * bix.element_size() \
            + 2 * named.numel() * bip.element_size()
        flop = flops_per_product(dv.dtype) * products
        peak = peak_flops(dv.dtype)
        out_sparse = (len(whole[0]) * ip.element_size()
                      + nnz * (ix.element_size() + dv.element_size()))
        bounds = {
            "K4_csr_spgemm_count": bound(
                nbytes(ip, ix) + b_index + ip.numel() * 8, 0, peak),
            "K4 with its plan": bound(
                nbytes(ip, ix) + b_index + ip.numel() * 8, 0, peak),
            "K5_csr_spgemm_fill": bound(
                nbytes(ip, ix, dv) + b_moved + out_sparse, flop, peak),
            "K4+K5 product": bound(
                nbytes(ip, ix, dv) + b_moved + out_sparse, flop, peak),
        }

        def spgemm_library():
            a_t = torch.sparse_csr_tensor(ip, ix, dv, size=a.shape)
            b_t = torch.sparse_csr_tensor(bip, bix, bdv, size=b.shape)
            return ((lambda: torch.sparse.mm(a_t, b_t)),
                    "torch.sparse.mm(A_csr, B_csr) (cuSPARSE SpGEMM)")

        timed = [
            ("K4_csr_spgemm_count",
             lambda: spgemm.csr_spgemm_count(ip, ix, bip, bix, n, plan),
             lambda: spgemm.csr_spgemm_count_plain(ip, ix, bip, bix, n)),
            # K4 as csr_spgemm launches it: the plan built in its launch;
            # beside it, the torch plan and K4's plain version.
            ("K4 with its plan",
             lambda: spgemm.plan_and_count(ip, ix, bip, bix, n, dv.dtype)[1],
             lambda: (spgemm.spgemm_plan(ip, ix, bip, n, dv.dtype, ip.dtype),
                      spgemm.csr_spgemm_count_plain(ip, ix, bip, bix, n))[1]),
            ("K5_csr_spgemm_fill",
             lambda: spgemm.csr_spgemm_fill(*args, plan, whole[0], nnz,
                                            bin_sizes=sizes)[1],
             lambda: spgemm.csr_spgemm_fill_plain(*args)[1]),
            ("K4+K5 product",
             lambda: spgemm.csr_spgemm(*args)[2],
             lambda: spgemm.spgemm_plain(*args)[2]),
        ]
        for kernel, kernel_fn, plain_fn in timed:
            library = (library_call(spgemm_library)
                       if kernel == "K4+K5 product" else
                       (None, "none: no single PyTorch call computes this"))
            row = timed_row(kernel, shape, kernel_fn, plain_fn,
                            bounds[kernel], library, reps, case=case,
                            products=products, nnz=nnz,
                            bins=bin_rows(plan, sizes))
            row.update(gproducts_per_s=products / row["ms"] / 1e6,
                       plain_gproducts_per_s=products / row["plain_ms"] / 1e6)
            rows.append(row)
        if case in ("a", "c"):
            steps[case] = {"shape": shape, "steps": product_steps(args)}
        del A, B, args, plan, whole, ref
        torch.cuda.empty_cache()
    rows += k6_timings(inp)
    rows += k9_rows(inp)
    rows += k11_rows(inp)
    rows += batched_spgemm_rows(inp)

    wall = {"dot_product": [], "scipy": []}
    for _ in range(5):
        for name, fn in (("dot_product", lambda: sdt.dot_product(x, x.T)),
                         ("scipy", lambda: x @ x.T)):
            t0 = time.perf_counter()
            fn()
            wall[name].append((time.perf_counter() - t0) * 1e3)
    emit("4-spgemm", rows=rows, wall_ms_x_xT={
        name: spread(t) for name, t in wall.items()},
        timer="cuda events, median (p10, p90), 1 GiB read before each; "
              "wall: host clock, median (p10, p90) of 5")
    emit("4-spgemm-steps", cases=steps,
         timer="device: cuda events after each step; host: host clock "
               "around each step; median (p10, p90), 1 GiB read before "
               "each product")
    return rows


def k6_work(ip, ix, bip, bix, n, triangular):
    """(products, entries of op(B) read, rows of op(B) read) of K6 for
    op(A) = (ip, ix), op(B) = (bip, bix) and n columns: every product and
    each entry of op(B) that op(A) names, once; with ``triangular`` only
    the products of columns j >= i, and of op(B)'s row k only the entries
    of columns j >= the least row i that names it (op(B)'s rows must be
    sorted)."""
    m, k = ip.numel() - 1, bip.numel() - 1
    kk = ix.long()
    b_start, b_end = bip[:-1].long(), bip[1:].long()
    if not triangular:
        named = torch.unique(kk)
        return (int((b_end - b_start)[kk].sum()),
                int((b_end - b_start)[named].sum()), int(named.numel()))
    dev = ip.device
    rows = torch.repeat_interleave(torch.arange(m, device=dev),
                                   ip.long().diff()).clamp(max=n)
    bkey = (torch.repeat_interleave(torch.arange(k, device=dev),
                                    b_end - b_start) * n + bix.long())
    if not bool((bkey[1:] >= bkey[:-1]).all()):
        raise AssertionError("K6 triangular bound: op(B)'s rows not sorted")
    first = torch.searchsorted(bkey, kk * n + rows)
    least = torch.full((k,), n, dtype=torch.long, device=dev).scatter_reduce(
        0, kk, rows, "amin")
    read = b_end - torch.searchsorted(
        bkey, torch.arange(k, device=dev) * n + least)
    return (int((b_end[kk] - first).sum()), int(read.sum()),
            int((read > 0).sum()))


def k6_bound(args, triangular):
    """K6's bound (``bound``) and products: op(A)'s arrays and the entries
    of op(B) it needs, read once (``k6_work``), the m x n output written
    once; one multiply-add a product, on the CUDA cores."""
    ip, ix, dv, bip, bix, bdv, n = args
    products, read, named = k6_work(ip, ix, bip, bix, n, triangular)
    moved = (nbytes(ip, ix, dv) + read * (bix.element_size()
                                          + bdv.element_size())
             + 2 * named * bip.element_size()
             + (ip.numel() - 1) * n * dv.element_size())
    flop = flops_per_product(dv.dtype) * products
    return bound(moved, flop, peak_flops(dv.dtype)), products


def densify_matmul(args, shape_a, triangular):
    """K6's function the JAX package's way (``_xla.py``,
    ``spgemm_numeric_sorted``): both CSR operands densified
    (``to_dense``), one ``torch.matmul`` (TF32 off), ``triu`` for the
    gram.  A yardstick: the port never calls it.  Returns ((fn, note),
    parts): its three steps alone ({name: fn}, the dense operands made
    beforehand) to time beside it."""
    ip, ix, dv, bip, bix, bdv, n = args
    a = torch.sparse_csr_tensor(ip, ix, dv, size=shape_a)
    b = torch.sparse_csr_tensor(bip, bix, bdv, size=(shape_a[1], n))

    def run():
        c = torch.matmul(a.to_dense(), b.to_dense())
        return torch.triu(c) if triangular else c

    a_dense, b_dense = a.to_dense(), b.to_dense()
    parts = {"to_dense(A)": a.to_dense, "to_dense(B)": b.to_dense,
             "matmul": lambda: torch.matmul(a_dense, b_dense)}
    return (run, ("to_dense() of both CSR operands + torch.matmul, TF32 "
                  "off" + (", triu" if triangular else ""))), parts


def rows_of(lengths, width, seed):
    """CSR f64 whose row i holds lengths[i] distinct random columns,
    sorted (the recipe of ``tests/test_torch_spgemm.py``'s ``rows_of``)."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(width, n, replace=False)) for n in lengths]
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    data = rng.standard_normal(int(indptr[-1]))
    return sps.csr_matrix((data, np.concatenate(cols), indptr),
                          shape=(len(lengths), width))


def shuffled_rows(mat, rng):
    """A copy of CSR ``mat`` with each row's entries in random order."""
    out = mat.copy()
    for r in range(out.shape[0]):
        lo, hi = out.indptr[r], out.indptr[r + 1]
        perm = lo + rng.permutation(hi - lo)
        out.indices[lo:hi] = out.indices[perm]
        out.data[lo:hi] = out.data[perm]
    return out


# K6's shapes in phase 4: (case, description, op(A), op(B), triangular,
# reps, yardstick).  a and d as ``spgemm_timings``; a-tri is the gram's
# launch; a-f32 and a-i64 the other value width and index width at case
# a; d and mid-16k (n = 16,384, a row of f64 within the parent design's
# 200 KB of shared memory) over op(B) shuffled, which the wrapper sorts
# on every call; the wide cases are phase 2's n = 100,000 shape and the
# tests' WIDE_N = 40,000 (a dense f64 row of either exceeds shared
# memory) over op(B) sorted and shuffled.
def k6_cases(inp):
    rng = np.random.default_rng(SEED + 3)
    x = inp["x"]
    wide_a = rows_of([SPGEMM_A_ROWS[i % len(SPGEMM_A_ROWS)]
                      for i in range(42)], 2000, SEED + 5)
    wide_b = rows_of([20] * 2000, 100_000, SEED + 4)
    narrow_a = rows_of([0, 1, 5, 40, 300, 2], 600, 3)
    narrow_b = rows_of([30] * 600, 40_000, 4)
    mid_a = rows_of([64] * 1000, 2000, SEED + 6)
    mid_b = rows_of([200] * 2000, 16_384, SEED + 7)
    return (
        ("a", "demo X @ X.T, X 500x5000 CSR 21.2% f64", x, x.T, False,
         REPS, True),
        ("a-tri", "gram_matrix(X, transpose=True, dense=True): X @ X.T, "
         "j >= i", x, x.T, True, REPS, True),
        ("a-f32", "demo X @ X.T in f32", x.astype(np.float32),
         x.T.astype(np.float32), False, REPS, False),
        ("a-i64", "demo X @ X.T, int64 indices", x, x.T, False, REPS,
         False),
        ("d", "config3 BSR bs=64 8192^2 5% blocks f64, A @ B", inp["bsr_a"],
         inp["bsr_b"], False, REPS_CONFIG3, True),
        ("d-shuffled", "the same, op(B) as CSR with its rows shuffled",
         inp["bsr_a"], shuffled_rows(inp["bsr_b"].tocsr(), rng), False,
         REPS_CONFIG3, False),
        ("mid-16k", "1000x2000 (64 a row) @ 2000x16384 (200 a row) f64, "
         "sorted", mid_a, mid_b, False, 10, False),
        ("mid-16k-shuffled", "the same, op(B)'s rows shuffled", mid_a,
         shuffled_rows(mid_b, rng), False, 10, False),
        ("wide-100k", "42x2000 (rows of 0-600) @ 2000x100000 (20 a row) "
         "f64, sorted", wide_a, wide_b, False, 10, False),
        ("wide-100k-shuffled", "the same, op(B)'s rows shuffled", wide_a,
         shuffled_rows(wide_b, rng), False, 10, False),
        ("wide-40k", "6x600 (rows of 0-300) @ 600x40000 (30 a row) f64, "
         "sorted", narrow_a, narrow_b, False, 10, False),
        ("wide-40k-shuffled", "the same, op(B)'s rows shuffled", narrow_a,
         shuffled_rows(narrow_b, rng), False, 10, False),
    )


def k6_timings(inp):
    """Phase 4's K6 rows (``k6_cases``): kernel, plain version and, at a,
    a-tri and d, the densify + matmul yardstick (``densify_matmul``), with
    the bound (``k6_bound``) and the launch plan."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    wrapper = spgemm.csr_spgemm_dense
    rows = []
    for case, shape, a, b, tri, reps, yard in k6_cases(inp):
        A = formats.to_device(a)
        # The shuffled operands are built from their arrays, as a caller
        # with unsorted rows would: their order is found out on the card.
        B = (formats.CSR(*(cuda(arr) for arr in (b.data, b.indices,
                                                 b.indptr)), b.shape)
             if "shuffled" in case else formats.to_device(b))
        args = (*A.csr_arrays(), *B.csr_arrays(), b.shape[1])
        if case.endswith("-i64"):
            args = tuple(arr.long() if i in (0, 1, 3, 4) else arr
                         for i, arr in enumerate(args))
        kw = {"triangular": tri, "b_sorted": B.csr_sorted()}
        (bound_ms, bound_by), products = k6_bound(
            args, tri and "shuffled" not in case)
        yardstick, parts = (densify_matmul(args, a.shape, tri) if yard
                            else (None, None))
        row = timed_row(
            "K6_csr_spgemm_dense", shape, lambda: wrapper(*args, **kw),
            lambda: spgemm.csr_spgemm_dense_plain(*args, triangular=tri),
            (bound_ms, bound_by), reps=reps, yardstick=yardstick,
            beside=parts, case=case, products=products,
            b_sorted=kw["b_sorted"])
        row["plan"] = wrapper.last_plan._asdict()
        row["window_starts_table"] = wrapper.last_table
        row["gproducts_per_s"] = products / row["ms"] / 1e6
        rows.append(row)
        del A, B, args
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 4 for K12 and the densify route: K12's rows and the crossovers
# ---------------------------------------------------------------------------


def k12_rows(inputs, solver_inp):
    """K12's rows: config 1's A, the demo X and PARDISO's n = 12,000
    matrix (its dense LU's operand), each beside
    ``torch.sparse_csr_tensor(...).to_dense()``; the bound is the dense
    output written once and A's arrays read once."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import densify

    rows = []
    for shape, mat in (
            ("config1 CSR f64 10000x10000 1%", inputs["a1"]),
            ("demo X CSR f64 500x5000 21.2%", demo_x()),
            ("PARDISO LU operand CSR f64 12000x12000", solver_inp["lu_a"])):
        A = formats.to_device(mat.tocsr())
        ip, ix, dv = A.indptr, A.indices, A.data
        m, k = A.shape
        written = m * k * dv.element_size()

        def make(ip=ip, ix=ix, dv=dv, m=m, k=k):
            a = torch.sparse_csr_tensor(ip, ix, dv, size=(m, k))
            return a.to_dense, "torch.sparse_csr_tensor(...).to_dense()"

        row = timed_row(
            "K12_csr_densify", shape,
            lambda: densify.csr_densify(ip, ix, dv, (m, k)),
            lambda: densify.csr_densify_plain(ip, ix, dv, (m, k)),
            bound(written + nbytes(ip, ix, dv), 0, 1.0),
            library_call(make), nnz=int(ix.numel()),
            rows_per_tile=densify.densify_plan(m, k, dv.element_size()))
        row["gbytes_written_per_s"] = written / row["ms"] / 1e6
        rows.append(row)
        del A, ip, ix, dv
        torch.cuda.empty_cache()
    return rows


def k13_rows(device_match="compact"):
    """K13's rows at the main path's shapes: the demo X @ X.T's C and P
    (case a; with ``triangular``, the gram's) and the c128 gram X^T X of
    BASELINE config 4's X (5000^2, ``triangular``), each beside the
    yardstick ``torch.nonzero`` of the mask and C gathered there; no
    single torch call keeps a mask's explicit zeros.  The bound: P read
    once (its upper triangle with ``triangular``), C's entries at the mask
    read, the CSR written.  Then K12's indicator template on the demo X and
    on config 1's A, beside the design it replaced (K12 on ones in f32,
    cast to bf16) in the same turns.  K13's rows carry ``device_ms``: the
    device time of the call's kernels (those whose names hold
    ``device_match``) from a profiler trace."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import compact, densify

    rows = []
    x = demo_x()
    xc = (x + 0.5j * x).astype(np.complex128).tocsr()
    for shape, mat, ata, tri in (
            ("case a: demo X @ X.T, C 500^2 f64", x, False, False),
            ("case a-tri: the demo's gram, C 500^2 f64", x, False, True),
            ("config 4's c128 gram X^T X, C 5000^2", xc, True, True)):
        planes = formats.to_device(mat).dense_planes()
        a, ia = (planes.dense.mT, planes.indicator.mT) if ata else \
            (planes.dense, planes.indicator)
        c, p = a @ a.mT, ia @ ia.mT
        nnz, r = compact.csr_compact(c, p, tri)[1].numel(), p.shape[0]
        read = (r * (r + 1) // 2 if tri else r * r) * p.element_size()
        moved = (read + nnz * c.element_size() + (r + 1) * 4
                 + nnz * (4 + c.element_size()))

        def yardstick(c=c, p=p, tri=tri):
            def run():
                idx = torch.nonzero(compact._mask(p, tri, 0))
                return c[idx[:, 0], idx[:, 1]]
            return run, "torch.nonzero(mask) + C gathered at it"

        rows.append(timed_row(
            "K13_csr_compact", shape,
            lambda c=c, p=p, tri=tri: compact.csr_compact(c, p, tri)[2],
            lambda c=c, p=p, tri=tri: compact.csr_compact_plain(
                c, p, tri)[2],
            bound(moved, 0, 1.0),
            (None, "none: no single torch call keeps a mask's explicit "
                   "zeros"),
            yardstick=yardstick(), nnz=nnz, triangular=tri,
            device_match=device_match))
        del planes, a, ia, c, p
        torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 14)
    for shape, mat in (("demo X CSR 500x5000 21.2%", x),
                       ("config1 CSR 10000x10000 1%", config1_csr(
                           rng, SIZES["config1"]))):
        A = formats.to_device(mat)
        ip, ix, m, k = A.indptr, A.indices, *A.shape
        ones = torch.ones(ix.numel(), dtype=torch.float32, device="cuda")

        def make(ip=ip, ix=ix, m=m, k=k):
            a = torch.sparse_csr_tensor(ip, ix, torch.ones(
                ix.numel(), dtype=torch.bfloat16, device="cuda"),
                size=(m, k))
            return a.to_dense, ("torch.sparse_csr_tensor(indptr, indices, "
                                "ones bf16).to_dense()")

        row = timed_row(
            "K12_csr_indicator", shape,
            lambda ip=ip, ix=ix, m=m, k=k: densify.csr_indicator(
                ip, ix, (m, k)),
            lambda ip=ip, ix=ix, m=m, k=k: densify.csr_indicator_plain(
                ip, ix, (m, k)),
            bound(m * k * 2 + nbytes(ip, ix), 0, 1.0), library_call(make),
            beside={"K12 on ones f32, .to(bfloat16)":
                    lambda ip=ip, ix=ix, ones=ones, m=m, k=k:
                    densify.csr_densify(ip, ix, ones, (m, k)).to(
                        torch.bfloat16)},
            nnz=int(ix.numel()))
        row["gbytes_written_per_s"] = m * k * 2 / row["ms"] / 1e6
        rows.append(row)
        del A, ip, ix, ones
        torch.cuda.empty_cache()
    return rows


# The crossover sweep: K2 against K12 + torch.matmul at config 1's side,
# and K6 against it at the demo X's shape (X @ X.T).
SWEEP_SIDE = 10_000
SWEEP_NS = (16, 128, 512)
SWEEP_PERCENT = (0.5, 1, 2, 5, 10, 20, 40)
SWEEP_TYPES = (torch.float32, torch.float64, torch.complex64,
               torch.complex128)
K6_SWEEP_PERCENT = (1, 5, 21.2, 50)
# The sparse-output sweep: K4 + K5 against the structural densify route at
# the demo X's shape (K6_SWEEP_PERCENT) and at SWEEP_SIDE^2 A @ A.
SQUARE_SWEEP_PERCENT = (0.1, 1, 5)
# A point's calls whose first run took longer than this many ms are timed
# SWEEP_SLOW_REPS times, not REPS.
SWEEP_SLOW_MS = 20.0
SWEEP_SLOW_REPS = 7


def sweep_pattern(side, density, gen):
    """(indptr, indices) int32 of a side x side CSR on the card, each
    position stored with probability ``density`` (rows sorted, no
    repeats)."""
    ids = (torch.rand((side, side), device="cuda", generator=gen)
           < density).nonzero()
    indptr = torch.zeros(side + 1, dtype=torch.int32, device="cuda")
    indptr[1:] = torch.bincount(ids[:, 0], minlength=side).cumsum(0)
    return indptr, ids[:, 1].to(torch.int32).contiguous()


def synced(fn):
    """``fn`` followed by a host sync, as ``dot_product`` follows either
    route with the host read of its result."""
    def run():
        fn()
        torch.cuda.synchronize()
    return run


def finite_read(*tensors):
    """The densify routes' finite check alone: each tensor's sum's flag,
    read on the host in one copy."""
    return all(torch.stack([torch.isfinite(t.sum())
                            for t in tensors]).tolist())


def sweep_point(kernel_fn, route_fn, parts, dense_chosen):
    """One crossover point: the kernel's and the densify route's results
    against each other (``compare``), then both (each up to the host sync
    that reading its result takes) and the route's parts (device time)
    timed in turns; the gate's choice beside the faster route."""
    t0 = time.perf_counter()
    out_k = kernel_fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    err = compare(route_fn(), out_k, out_k.dtype)
    del out_k
    reps = SWEEP_SLOW_REPS if first_ms > SWEEP_SLOW_MS else REPS
    times = time_turns({"kernel": synced(kernel_fn),
                        "route": synced(route_fn), **parts}, reps)
    ms = {name: spread(t)[0] for name, t in times.items()}
    faster = "densify" if ms["route"] < ms["kernel"] else "kernel"
    chosen = "densify" if dense_chosen else "kernel"
    gap = (max(ms["route"], ms["kernel"]) / min(ms["route"], ms["kernel"])
           - 1.0)
    return {"kernel_ms": ms["kernel"], "route_ms": ms["route"],
            **{f"{name}_ms": ms[name] for name in parts},
            "gate": chosen, "faster": faster, "gap": gap,
            "gate_right": chosen == faster or gap <= 0.10,
            "max_abs_err": err, "reps": reps}


def densify_sweep():
    """Phase 4's crossover sweep (``4-densify``).  K2 (with its cached
    plan, as ``dot_product`` passes it) against the densify route as
    ``ops.host.densified_spmm`` runs it (K12 on A's arrays,
    ``torch.matmul``, the finite flag of B read on the host), each up to
    a host sync, at SWEEP_SIDE^2 for n in SWEEP_NS, densities
    in SWEEP_PERCENT and the value types SWEEP_TYPES; beside them the
    route's parts alone: the check (its host read included), K12 and the
    matmul.  Then K6 (op(B) sorted, as the public path passes it) against
    the route as ``ops.host.densified_product`` runs it at the demo X's
    shape, X @ X.T (one densify) with and without ``triangular``, at
    K6_SWEEP_PERCENT (21.2: the demo X itself) in the four value types,
    and X @ Y.T (two operands) in f64.  Each point checked first (both
    results held against each other), then timed in turns; each prints
    both times, the gate's choice, the faster route and whether the gate
    took it (or they lie within 10%).  No planes are kept in the sweep
    (``config.spgemm_plane_cache`` off): each route pays its densify, as
    a first use does and as the gates forecast it."""
    from sparse_dot_tpu_torch.config import config

    config.spgemm_plane_cache = False
    try:
        sweep_routes()
    finally:
        config.spgemm_plane_cache = True


def sweep_routes():
    """The points of ``densify_sweep``, the fit and the ``4-densify``
    line."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import csr, host, spgemm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    spmm_points, product_points = [], []
    for pct in SWEEP_PERCENT:
        ip, ix = sweep_pattern(SWEEP_SIDE, pct / 100.0, gen)
        nnz = int(ix.numel())
        for tdt in SWEEP_TYPES:
            dv = (torch.randn(nnz, dtype=tdt, device="cuda", generator=gen)
                  / np.sqrt(SWEEP_SIDE * pct / 100.0))
            A = formats.CSR(dv, ix, ip, (SWEEP_SIDE, SWEEP_SIDE), True)
            plan = A.csr_plan()
            a_dense = A.dense()
            for n in SWEEP_NS:
                b = torch.randn((SWEEP_SIDE, n), dtype=tdt, device="cuda",
                                generator=gen)
                point = sweep_point(
                    lambda: csr.csr_spmm(ip, ix, dv, b, plan=plan),
                    lambda: host.densified_spmm(A, b, False),
                    {"check": lambda: finite_read(b),
                     "k12": A.dense,
                     "matmul": lambda: torch.matmul(a_dense, b)},
                    host._prefer_densify(SWEEP_SIDE, SWEEP_SIDE, n, nnz, tdt,
                                         dev))
                point.update(percent=pct, n=n, dtype=str(tdt), nnz=nnz)
                spmm_points.append(point)
                del b
            del A, dv, plan, a_dense
            torch.cuda.empty_cache()
        del ip, ix
    for i, pct in enumerate(K6_SWEEP_PERCENT):
        x = demo_x() if pct == 21.2 else sps.random(
            500, 5000, density=pct / 100.0, format="csr", dtype=np.float64,
            random_state=100 + i)
        y = sps.random(500, 5000, density=pct / 100.0, format="csr",
                       dtype=np.float64, random_state=200 + i)
        for tdt in (torch.float64, torch.float32, torch.complex64,
                    torch.complex128):
            npdt = NP_DTYPES[tdt]
            xd = (x + 0.5j * x if tdt.is_complex else x).astype(npdt)
            A = formats.to_device(xd.tocsr())
            pairs = [("x_xT", A.T, True)]
            if tdt == torch.float64:
                pairs.append(("x_yT", formats.to_device(
                    y.astype(npdt).T), False))
            for case, B, one in pairs:
                args = host._product_arrays(A, B, npdt, sort_b=True)
                a_dense = A.dense(dtype=tdt)
                b_dense = a_dense.mT if one else B.dense(dtype=tdt)
                for tri in (False, True):
                    finite_of = (A.data,) if one else (A.data, B.data)
                    point = sweep_point(
                        lambda: spgemm.csr_spgemm_dense(
                            *args, 500, triangular=tri, b_sorted=True),
                        lambda: host.densified_product(
                            A, B, tdt, triangular=tri),
                        {"check": lambda: finite_read(*finite_of),
                         "k12": lambda: (A.dense(dtype=tdt), None if one
                                         else B.dense(dtype=tdt)),
                         "matmul": lambda: torch.matmul(a_dense, b_dense)},
                        host._prefer_densify_product(
                            500, 5000, 500, A.nnz, B.nnz, tdt, dev, one,
                            tri))
                    point.update(percent=pct, case=case, triangular=tri,
                                 dtype=str(tdt), nnz=int(A.nnz),
                                 b_nnz=int(B.nnz), one_operand=one,
                                 products_estimate=A.nnz * B.nnz / 5000)
                    product_points.append(point)
    sparse_points = sparse_sweep(gen)
    misses = [p for p in spmm_points + product_points + sparse_points
              if not p["gate_right"]]
    fitted, fit_misses = fit_gate(spmm_points, product_points, sparse_points)
    emit("4-densify", card=card_line(), spmm=spmm_points,
         product=product_points, sparse=sparse_points,
         gate_misses=len(misses),
         gate_constants=gate_constants(), fitted=fitted,
         fitted_gate_misses=fit_misses,
         timer="cuda events, median of REPS (SWEEP_SLOW_REPS where a call "
               f"took over {SWEEP_SLOW_MS} ms), 1 GiB read before each, "
               "kernel, route and parts in the same turns")


def sparse_sweep(gen):
    """The sparse-output points of ``densify_sweep``: K4 + K5 (as
    ``spgemm_device`` runs it: plan, count, the nnz read, fill) against the
    structural densify route as ``ops.host.densified_sparse_product`` runs
    it with no planes kept (K12 and its indicator, the two
    ``torch.matmul``, K13 with its host read), each up to its host sync, at
    the demo X's shape: X @ X.T with and without ``triangular`` and X @
    Y.T, at K6_SWEEP_PERCENT in the four value types; A @ A at
    SWEEP_SIDE^2 (one densify) at SQUARE_SWEEP_PERCENT in the four value
    types; and case d, config 3's BSR x BSR (f64); no planes kept (the
    sweep turns the cache off).  Beside
    them the route's parts alone (device time) and the route on a
    container whose planes are kept (``route_kept``: its repeat calls)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.config import config
    from sparse_dot_tpu_torch.ops import compact, densify, host, spgemm

    dev = torch.device("cuda")
    points = []

    def kept(fn):
        def run():
            config.spgemm_plane_cache = True
            try:
                return fn()
            finally:
                config.spgemm_plane_cache = False
        return run

    def point(A, B, tdt, tri, one, **extra):
        m, k, n = A.shape[0], A.shape[1], B.shape[1]
        npdt = NP_DTYPES[tdt]
        args = host._product_arrays(A, B, npdt)
        pa = A.dense_planes(dtype=tdt)
        if one:
            b, ib = ((pa.dense, pa.indicator) if B is A
                     else (pa.dense.mT, pa.indicator.mT))
        else:
            pb = B.dense_planes(dtype=tdt)
            b, ib = pb.dense, pb.indicator
        c, p = torch.matmul(pa.dense, b), torch.matmul(pa.indicator, ib)
        operands = (A,) if one else (A, B)

        def stored(M):
            ip, ix, _, shape = M._stored_csr()
            return ip, ix, shape

        parts = {"k12": lambda: [M.dense(dtype=tdt) for M in operands],
                 "indicator": lambda: [densify.csr_indicator(*stored(M))
                                       for M in operands],
                 "matmul": lambda: torch.matmul(pa.dense, b),
                 "matmul_indicator": lambda: torch.matmul(pa.indicator, ib),
                 "k13": lambda: compact.csr_compact(c, p, tri)}
        # The route on kept planes, where the cache's budget holds them.
        if m * k * (tdt.itemsize + 2) <= config.spgemm_plane_cache_bytes:
            parts["route_kept"] = kept(
                lambda: host.densified_sparse_product(A, B, tdt, tri))
        result = sweep_point(
            lambda: spgemm.csr_spgemm(*args, n, tri)[2],
            lambda: host.densified_sparse_product(A, B, tdt, tri).data,
            parts,
            host._prefer_densify_sparse_product(
                m, k, n, A.nnz, B.nnz, tdt, dev, one, tri))
        products = A.nnz * B.nnz / k
        result.update(dtype=str(tdt), triangular=tri, one_operand=one,
                      m=m, k=k, n=n, nnz=int(A.nnz), b_nnz=int(B.nnz),
                      products_estimate=products,
                      entries_estimate=-m * n * math.expm1(-products
                                                           / (m * n)),
                      c_nnz=int(compact.masked_compact(c, p, tri)[3]),
                      **extra)
        points.append(result)
        A.__dict__.pop("_planes", None)

    for i, pct in enumerate(K6_SWEEP_PERCENT):
        x = demo_x() if pct == 21.2 else sps.random(
            500, 5000, density=pct / 100.0, format="csr",
            dtype=np.float64, random_state=100 + i)
        y = sps.random(500, 5000, density=pct / 100.0, format="csr",
                       dtype=np.float64, random_state=200 + i)
        for tdt in SWEEP_TYPES:
            npdt = NP_DTYPES[tdt]
            xd, yd = ((m + 0.5j * m if tdt.is_complex else m).astype(npdt)
                      for m in (x, y))
            A = formats.to_device(xd.tocsr())
            for tri in (False, True):
                point(A, A.T, tdt, tri, True, percent=pct, case="x_xT")
            point(A, formats.to_device(yd.T), tdt, False, False,
                  percent=pct, case="x_yT")
            del A
            torch.cuda.empty_cache()
    for pct in SQUARE_SWEEP_PERCENT:
        ip, ix = sweep_pattern(SWEEP_SIDE, pct / 100.0, gen)
        for tdt in SWEEP_TYPES:
            dv = (torch.randn(ix.numel(), dtype=tdt, device="cuda",
                              generator=gen)
                  / np.sqrt(SWEEP_SIDE * pct / 100.0))
            A = formats.CSR(dv, ix, ip, (SWEEP_SIDE, SWEEP_SIDE), True)
            point(A, A, tdt, False, True, percent=pct, case="a_a_10000")
            del A, dv
            torch.cuda.empty_cache()
        del ip, ix
    rng = np.random.default_rng(SEED + 15)
    a, b = (formats.to_device(config3_bsr(rng, SIZES["config3"],
                                          np.float64, 64))
            for _ in range(2))
    point(a, b, torch.float64, False, False, percent=5.0,
          case="d_config3_bsr_x_bsr")
    return points


def gate_constants():
    """The cost models' constants in ``ops.host``, as the run used them."""
    from sparse_dot_tpu_torch.ops import host

    def by_type(table):
        return {str(k): v for k, v in table.items()}

    return {"k2_s": by_type(host._K2_S), "k6_s": by_type(host._K6_S),
            "k12_s": by_type(host._K12_S), "matmul_s": host._MATMUL_S,
            "matmul": by_type(host._MATMUL),
            "dense_route_s": host._DENSE_ROUTE_S,
            "dense_product_s": host._DENSE_PRODUCT_S,
            "k45_s": by_type(host._K45_S), "k13_s": host._K13_S,
            "dense_sparse_s": host._DENSE_SPARSE_S,
            "k1_s": host._K1_S, "k1_flops": host._K1_FLOPS,
            "k2_rows": host._K2_ROWS,
            "dense_cap_bytes": host.DENSE_CAP_BYTES}


def relative_fit(columns, seconds):
    """Non-negative least squares of ``seconds`` by ``columns`` in
    relative error (each row divided by its time): the coefficients."""
    from scipy.optimize import nnls

    a = np.stack([np.asarray(c, float) / seconds for c in columns], axis=1)
    return nnls(a, np.ones(len(seconds)))[0]


def near_crossover(points, least):
    """The points whose two routes lie within 3x of each other, where the
    gate's choice is made (all of them when fewer than ``least`` do)."""
    near = [p for p in points if 1 / 3 < p["route_ms"] / p["kernel_ms"] < 3]
    return near if len(near) >= least else points


def k2_log_rows(nnz, m):
    """ln(R_hi / r) of ``ops.host``'s K2 model: r, op(A)'s mean row, held
    within the rows the sweep spans (``host._K2_ROWS``)."""
    from sparse_dot_tpu_torch.ops import host

    lo, hi = host._K2_ROWS
    return np.log(hi / np.clip(np.asarray(nnz, float) / m, lo, hi))


def fit_gate(spmm_points, product_points, sparse_points):
    """The constants of ``ops.host``'s cost models fitted to this run's
    sweep, in the order the module holds them, and the points where a gate
    with them would miss the faster route by more than 10% (their
    forecasts beside the measured times).  K2's model is fitted near the
    crossover (``near_crossover``), K6's over every point (a triangular
    launch's products apart), the route's own seconds apart for SpMM and
    for sparse x sparse of one and of two operands; for sparse output
    (``fit_sparse``) K4 + K5's, the indicator's, the bf16 product's, K13's
    and the structural route's own."""
    types = {str(t): t for t in SWEEP_TYPES}
    side2 = SWEEP_SIDE * SWEEP_SIDE
    k2, k12, mm, k6 = {}, {}, {}, {}
    for name, tdt in types.items():
        pts = [p for p in spmm_points if p["dtype"] == name]
        near = near_crossover(pts, 5)
        nnz = np.array([p["nnz"] for p in near], float)
        n = np.array([p["n"] for p in near], float)
        sec = np.array([p["kernel_ms"] for p in near]) / 1e3
        k2[name] = relative_fit((np.ones_like(nnz), nnz, nnz * n, nnz * n
                                 * k2_log_rows(nnz, SWEEP_SIDE)), sec)
        sec = np.array([p["k12_ms"] for p in pts]) / 1e3
        k12[name] = relative_fit(([side2 * tdt.itemsize] * len(pts),
                                  [p["nnz"] for p in pts]), sec)
        flop = 2.0 * side2 * (4 if tdt.is_complex else 1)
        t16 = np.median([p["matmul_ms"] for p in pts if p["n"] == 16]) / 1e3
        t512 = np.median([p["matmul_ms"] for p in pts
                          if p["n"] == 512]) / 1e3
        mm[name] = [t16 / (side2 * tdt.itemsize), flop * 512 / t512]
    resid = []
    for p in product_points:
        tdt = types[p["dtype"]]
        per_byte, flops = mm[p["dtype"]]
        flop = 2.0 * 500 * 5000 * 500 * (4 if tdt.is_complex else 1)
        resid.append(p["matmul_ms"] / 1e3 - max(
            500 * 5000 * tdt.itemsize * per_byte, flop / flops))
    mm_fixed = max(0.0, float(np.median(resid)))
    for name, tdt in types.items():
        fits = []
        for tri in (False, True):
            pts = [p for p in product_points
                   if p["dtype"] == name and p["triangular"] == tri]
            sec = np.array([p["kernel_ms"] for p in pts]) / 1e3
            fits.append(relative_fit(([1.0] * len(pts), [
                p["products_estimate"] for p in pts]), sec))
        # The triangular launch's share of the full one's time a product.
        k6[name] = [fits[0][0], fits[0][1], fits[1][1] / fits[0][1]]

    def route_s(points):
        return float(np.median([
            (p["route_ms"] - p["k12_ms"] - p["matmul_ms"]) / 1e3
            for p in points]))

    fitted = {"k2_s": k2, "k12_s": k12, "matmul": mm, "matmul_s": mm_fixed,
              "k6_s": k6, "dense_route_s": route_s(spmm_points),
              "dense_product_s": [
                  route_s([p for p in product_points if p["one_operand"]]),
                  route_s([p for p in product_points
                           if not p["one_operand"]])]}
    fitted.update(fit_sparse(sparse_points, fitted))
    fitted = json.loads(json.dumps(fitted, default=lambda v: v.tolist()))
    misses = []
    for p in spmm_points + product_points:
        tdt = types[p["dtype"]]
        if "n" in p:
            m, k, n, elements, nnz = SWEEP_SIDE, SWEEP_SIDE, p["n"], side2, \
                p["nnz"]
            fixed, a, b, d = fitted["k2_s"][p["dtype"]]
            kernel = fixed + nnz * (a + n * (b + d * float(
                k2_log_rows(nnz, m))))
            own = fitted["dense_route_s"]
        else:
            m, k, n = 500, 5000, 500
            one = p["one_operand"]
            elements = m * k if one else 2 * m * k
            nnz = p["nnz"] if one else p["nnz"] + p["b_nnz"]
            fixed, per, tri = fitted["k6_s"][p["dtype"]]
            kernel = fixed + per * p["products_estimate"] * (
                tri if p["triangular"] else 1.0)
            own = fitted["dense_product_s"][0 if one else 1]
        w, e = fitted["k12_s"][p["dtype"]]
        per_byte, flops = fitted["matmul"][p["dtype"]]
        flop = 2.0 * m * k * n * (4 if tdt.is_complex else 1)
        dense_s = (own + elements * tdt.itemsize * w + nnz * e
                   + fitted["matmul_s"]
                   + max(m * k * tdt.itemsize * per_byte, flop / flops))
        chosen = "densify" if dense_s < kernel else "kernel"
        if chosen != p["faster"] and p["gap"] > 0.10:
            misses.append({key: p.get(key) for key in (
                "dtype", "percent", "n", "case", "triangular", "kernel_ms",
                "route_ms")} | {"forecast_kernel_ms": kernel * 1e3,
                                "forecast_route_ms": dense_s * 1e3})
    for p in sparse_points:
        kernel, dense_s = sparse_forecast(p, fitted)
        chosen = "densify" if dense_s < kernel else "kernel"
        if chosen != p["faster"] and p["gap"] > 0.10:
            misses.append({key: p.get(key) for key in (
                "dtype", "percent", "case", "triangular", "kernel_ms",
                "route_ms")} | {"forecast_kernel_ms": kernel * 1e3,
                                "forecast_route_ms": dense_s * 1e3})
    return fitted, misses


BF16 = str(torch.bfloat16)


def sparse_forecast(p, c):
    """(K4 + K5's seconds, the structural route's) at sweep point ``p``
    by ``ops.host._prefer_densify_sparse_product``'s models with the
    constants ``c`` (``fit_gate``'s names)."""
    tdt = {str(t): t for t in SWEEP_TYPES}[p["dtype"]]
    m, k, n, item = p["m"], p["k"], p["n"], tdt.itemsize
    one = p["one_operand"]
    elements = m * k if one else m * k + k * n
    nnz = p["nnz"] if one else p["nnz"] + p["b_nnz"]
    fixed, per_p, per_log, per_e, spread, tri = c["k45_s"][p["dtype"]]
    share = tri if p["triangular"] else 1.0
    entries = p["entries_estimate"]
    kernel = fixed + share * (
        p["products_estimate"] * (1 + spread / m) * (per_p + per_log * float(
            k45_log_rows(p["products_estimate"], m))) + per_e * entries)

    def matmul(dt, bytes_per_element):
        per_byte, flops = c["matmul"][dt]
        flop = 2.0 * m * k * n * (4 if dt.startswith("torch.complex")
                                  else 1)
        return c["matmul_s"] + max(m * k * bytes_per_element * per_byte,
                                   flop / flops)

    w, e = c["k12_s"][p["dtype"]]
    wi, ei = c["k12_s"][BF16]
    dense = (c["dense_sparse_s"][0 if one else 1]
             + elements * (item * w + 2 * wi) + nnz * (e + ei)
             + matmul(p["dtype"], item) + matmul(BF16, 2)
             + c["k13_s"] * (4 * m * n + share * entries * (2 * item + 4)))
    return kernel, dense


# The candidate S of K4 + K5's model (``fit_sparse``).
K45_SPREADS = (0, 125, 250, 500, 1000, 2000, 4000)


def k45_log_rows(products, m):
    """ln(R_hi / r) of ``ops.host``'s K4 + K5 model: r the products a row
    of op(A), held within ``host._K45_ROWS``."""
    from sparse_dot_tpu_torch.ops import host

    lo, hi = host._K45_ROWS
    return np.log(hi / np.clip(np.asarray(products, float)
                               / np.asarray(m, float), lo, hi))


def fit_sparse(points, fitted):
    """The sparse-output constants fitted to ``sparse_sweep``'s points:
    K4 + K5 by type (fixed seconds; seconds a product as (b + d ln(R_hi
    / r)) (1 + S / m), r the products a row (``k45_log_rows``: a row's
    work a product falls as its products grow) and S the rows below which
    part of the card idles, the best of K45_SPREADS; seconds an entry of
    C; from the full launches; the triangular launches' share of the rest,
    summed over them), K12's
    indicator template (a byte, an entry), the bf16 product (a byte at the
    demo shape; FLOP/s at SWEEP_SIDE^2), K13 (fixed and a byte; its fixed
    seconds go to the route's own), the route's own seconds (its time
    past its parts) of one operand and of two."""
    k45 = {}
    for name in {p["dtype"] for p in points}:
        full = [p for p in points if p["dtype"] == name
                and not p["triangular"]]
        prods = np.array([p["products_estimate"] for p in full])
        rows = np.array([p["m"] for p in full], float)
        logs = k45_log_rows(prods, rows)
        sec = np.array([p["kernel_ms"] for p in full]) / 1e3
        fits = []
        for spread in K45_SPREADS:
            work = prods * (1 + spread / rows)
            cols = (np.ones_like(prods), work, work * logs,
                    [p["entries_estimate"] for p in full])
            coef = relative_fit(cols, sec)
            resid = np.stack(cols, axis=1).astype(float) @ coef / sec - 1
            fits.append((float(resid @ resid), spread, coef))
        _, spread, (fixed, per_p, per_log, per_e) = min(
            fits, key=lambda f: f[0])
        tri = [p for p in points if p["dtype"] == name and p["triangular"]]

        def work(p):
            return (p["products_estimate"] * (1 + spread / p["m"]) * (
                per_p + per_log * float(k45_log_rows(
                    p["products_estimate"], p["m"])))
                + per_e * p["entries_estimate"])

        share = (sum(p["kernel_ms"] / 1e3 - fixed for p in tri)
                 / sum(work(p) for p in tri))
        k45[name] = [fixed, per_p, per_log, per_e, spread, share]

    def elements(p):
        return p["m"] * p["k"] * (1 if p["one_operand"] else 2)

    def entries_of(p):
        return p["nnz"] * (1 if p["one_operand"] else 2)

    indicator = relative_fit((
        [elements(p) * 2 for p in points], [entries_of(p) for p in points]),
        np.array([p["indicator_ms"] for p in points]) / 1e3)
    mm_fixed = fitted["matmul_s"]
    small = [p for p in points if p["m"] == 500]
    big = [p for p in points if p["m"] != 500]
    per_byte = float(np.median([(p["matmul_indicator_ms"] / 1e3 - mm_fixed)
                                / (p["m"] * p["k"] * 2) for p in small]))
    flops = float(np.median([2.0 * p["m"] * p["k"] * p["n"]
                             / (p["matmul_indicator_ms"] / 1e3 - mm_fixed)
                             for p in big]))
    item = {str(t): t.itemsize for t in SWEEP_TYPES}
    k13_bytes = [4 * p["m"] * p["n"] + (k45[p["dtype"]][5] if p["triangular"]
                                        else 1.0) * p["entries_estimate"]
                 * (2 * item[p["dtype"]] + 4) for p in points]
    k13_fixed, k13_s = relative_fit(([1.0] * len(points), k13_bytes),
                                    np.array([p["k13_ms"] for p in points])
                                    / 1e3)

    def own(pts):
        return float(np.median([
            (p["route_ms"] - p["k12_ms"] - p["indicator_ms"] - p["matmul_ms"]
             - p["matmul_indicator_ms"] - p["k13_ms"]) / 1e3 + k13_fixed
            for p in pts]))

    k12 = dict(fitted["k12_s"], **{BF16: indicator})
    matmul = dict(fitted["matmul"], **{BF16: [per_byte, flops]})
    return {"k45_s": k45, "k12_s": k12, "matmul": matmul, "k13_s": k13_s,
            "k13_fixed_s": k13_fixed,
            "dense_sparse_s": [own([p for p in points if p["one_operand"]]),
                               own([p for p in points
                                    if not p["one_operand"]])]}


def k6_batched_bound(args, size):
    """``k6_bound`` of a batched K6 call of ``size`` members: op(A)'s index
    arrays and the entries of op(B) it names once, each member's values
    (once for a shared operand), ``size`` outputs; ``size`` times the
    multiply-adds."""
    ip, ix, dv, bip, bix, bdv, n = args
    products, read, named = k6_work(ip, ix, bip, bix, n, False)
    moved = (nbytes(ip, ix) + dv.shape[-1] * members_of(dv, 1)
             * dv.element_size()
             + read * (bix.element_size()
                       + members_of(bdv, 1) * bdv.element_size())
             + 2 * named * bip.element_size()
             + size * (ip.numel() - 1) * n * dv.element_size())
    flop = size * flops_per_product(dv.dtype) * products
    return bound(moved, flop, peak_flops(dv.dtype))


def k9_batched_bound(args, size):
    """``k9_bound`` of a batched K9 call of ``size`` members (d and Y's
    values per member or shared)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    ip, ix, d, y_ip, y_ix, y_dv, _, transposed = args
    products, y_rows, y_entries = k9_work(ip, ix, y_ip, transposed)
    line, _ = spgemm_grad.entry_ids(ip, ix, transposed)
    d_lines = int(torch.unique(line.long()).numel())
    line_len = d.shape[-2] if transposed else d.shape[-1]
    moved = (nbytes(ip, ix)
             + members_of(d, 2) * d_lines * line_len * d.element_size()
             + 2 * y_rows * y_ip.element_size()
             + y_entries * (y_ix.element_size()
                            + members_of(y_dv, 1) * y_dv.element_size())
             + size * ix.numel() * d.element_size())
    flop = size * flops_per_product(d.dtype) * products
    return bound(moved, flop, peak_flops(d.dtype))


def k11_batched_bound(a, b, c, g, transposed, size):
    """``k11_bound`` of a batched K11 call of ``size`` members over G's
    values ``g`` (B, nnz(C)), op(A)'s and op(B)'s values shared."""
    products = int(b[0].long().diff()[a[1].long()].sum())
    p, y = (b, a) if transposed else (a, b)
    moved = (nbytes(p[0], p[1], *y, *c) + members_of(g, 1)
             * g.shape[-1] * g.element_size()
             + size * p[1].numel() * g.element_size())
    flop = size * flops_per_product(g.dtype) * products
    return bound(moved, flop, peak_flops(g.dtype))


def sampled_group(single, g, shared_y, k11_transposed=None):
    """{members, lines a member} of batched K9's launch (K11's, in the
    form ``k11_transposed`` says) over the members of ``g`` (G per
    member) whose single launch takes ``single``, Y's values shared or
    not (``spgemm_grad.group_plan``, ``sparse_group_plan``)."""
    from sparse_dot_tpu_torch.ops import spgemm_grad

    if k11_transposed is None:
        plan = spgemm_grad.group_plan(single, g.element_size(), g.shape[0],
                                      False, shared_y)
    else:
        plan = spgemm_grad.sparse_group_plan(
            single, g.element_size(), g.shape[0], (False, shared_y),
            k11_transposed)
    return {"members": plan.members,
            "lines_a_member": plan.panel if plan.staged else None}


def k5_batched_row(shape, a_np, b_np, a, b, c, rng, case, size=4):
    """Phase 4's row of batched K5 over ``size`` value sets of op(A),
    op(B) shared, on one plan (``fill_batched``: the wrapper's groups),
    beside the same members' single fills, the per-member instance (the
    parent's launch: ``most`` 1) and 4 x ``torch.sparse.mm(A_csr,
    B_csr)`` (cuSPARSE SpGEMM, which counts the pattern too) in the same
    turns; its bound the index arrays and C's structure once, each
    member's values and output."""
    from sparse_dot_tpu_torch.ops import spgemm

    ip, ix, dv = a
    bip, bix, bdv = b
    n = b_np.shape[1]
    plan = spgemm.spgemm_plan(ip, ix, bip, n, dv.dtype, ip.dtype)
    sizes = plan.offsets.diff().tolist()
    nnz = c[1].numel()
    av = dv[None] * (1 + 0.1 * cuda(values(rng, (size, ix.numel()),
                                           np.float64)))
    fill_args = (ip, ix, av, bip, bix, bdv, n)
    named = torch.unique(ix.long())
    b_len = (bip[1:] - bip[:-1]).long()[named]
    moved = (nbytes(ip, ix, av) + int(b_len.sum())
             * (bix.element_size() + bdv.element_size())
             + 2 * named.numel() * bip.element_size()
             + nbytes(*c) + size * nnz * dv.element_size())
    flop = size * flops_per_product(dv.dtype) * int(plan.ub.sum())
    mats = [torch.sparse_csr_tensor(ip, ix, av[i], size=a_np.shape)
            for i in range(size)]
    b_t = torch.sparse_csr_tensor(bip, bix, bdv, size=b_np.shape)
    groups = spgemm.fill_groups(plan.bins, dv.dtype, ip.dtype, size)
    per_member = spgemm._fill_launcher(*fill_args, plan, c[0], False, size)
    row = timed_row(
        "K5_csr_spgemm_fill",
        f"batched: {shape}, {size} value sets of op(A), op(B) shared, "
        "one plan",
        lambda: spgemm.fill_batched(*fill_args, plan, c[0], nnz,
                                    bin_sizes=sizes)[1],
        lambda: spgemm.csr_spgemm_fill_batched_plain(*fill_args)[1],
        bound(moved, flop, peak_flops(dv.dtype)),
        beside={f"{size}_single_launches": lambda: [
            spgemm.csr_spgemm_fill(ip, ix, av[i], bip, bix, bdv, n, plan,
                                   c[0], nnz, bin_sizes=sizes)[1]
            for i in range(size)],
            "per_member_instance": lambda: per_member(nnz, sizes, most=1)[1],
            "yardstick": lambda: [torch.sparse.mm(mat, b_t)
                                  for mat in mats]},
        yardstick_note=f"beside's yardstick: {size} x torch.sparse.mm("
                       "A_csr, B_csr) (cuSPARSE SpGEMM, which counts the "
                       "pattern too), one a member",
        device_match=K45_KERNELS,
        members=size, case=case,
        bins=bin_groups(plan, sizes, groups))
    return row


def k5_case_h_row(rng, side=100_000, mean_row=10):
    """``k5_batched_row`` at case h, whose rows fill K5's sorted-product
    bins (``side``^2, Poisson(``mean_row``) entries a row, A @ A, f64:
    about mean_row^2 products a row)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    a_np = poisson_square(side, mean_row)
    A = formats.to_device(a_np)
    a = A.csr_arrays()
    c = spgemm.csr_spgemm(*a, *a, side)[:2]
    row = k5_batched_row(f"{side // 1000}k x {side // 1000}k CSR, "
                         f"Poisson({mean_row}) a row, A @ A, f64, sparse "
                         "output (sorted-product bins)", a_np, a_np, a, a,
                         c, rng, "h")
    del A, a, c
    torch.cuda.empty_cache()
    return row


def batched_spgemm_rows(inp, groups_only=False):
    """Phase 4's rows of the batched sparse x sparse launches, each beside
    the same members' single launches in the same turns
    (``ms_over_single_launches``), f64: K6 at case a (the demo X @ X.T)
    over 4 and 16 value sets of op(A), op(B) shared; K9 at case a,
    dL/dA and dL/dB, over 4 G's, the values shared (``jacrev``'s and a
    batch of tangents' launch); K11 at cases a and c, dL/dA and dL/dB,
    over 4 G's on C's pattern; K5 at case c over 4 value sets of op(A)
    on one shared plan, beside 4 x ``torch.sparse.mm(A_csr, B_csr)``
    (cuSPARSE SpGEMM, which also counts the pattern) as its yardstick.
    Each with its bound (``k6_batched_bound``, ``k9_batched_bound``,
    ``k11_batched_bound``; K5: the index arrays and C's structure once,
    each member's values and output); K5 also at case h, whose rows
    fill the sorted-product bins (``k5_case_h_row``).  K6 also over 4
    value sets of op(B), op(A) shared; K6 and K5 beside their per-member
    instances too.  With ``groups_only`` the K6 and K5 rows alone (the
    member groups')."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import autograd, spgemm, spgemm_grad

    rng = np.random.default_rng(SEED + 25)
    shape_c = "1M x 1M CSR, 2M random nnz, A @ A, f64, sparse output"
    rows = []
    x = inp["x"]
    shape_a = "demo X @ X.T, X 500x5000 CSR 21.2% f64"
    A, B = formats.to_device(x), formats.to_device(x.T)
    ip, ix, dv = A.csr_arrays()
    bip, bix, bdv = B.sorted_csr_arrays()
    n = x.shape[0]
    for size, over in ((4, "A"), (16, "A"), (4, "B")):
        if over == "A":
            av, bv = dv[None] * (1 + 0.1 * cuda(values(
                rng, (size, ix.numel()), np.float64))), bdv
        else:
            av, bv = dv, bdv[None] * (1 + 0.1 * cuda(values(
                rng, (size, bix.numel()), np.float64)))
        args = (ip, ix, av, bip, bix, bv, n)
        rows.append(timed_row(
            "K6_csr_spgemm_dense",
            f"batched: {shape_a}, {size} value sets of op({over}), "
            f"op({'B' if over == 'A' else 'A'}) shared",
            lambda: spgemm.spgemm_dense_batched(*args, b_sorted=True),
            lambda: spgemm.csr_spgemm_dense_batched_plain(*args),
            k6_batched_bound(args, size),
            beside={f"{size}_single_launches": lambda: [
                spgemm.csr_spgemm_dense(
                    ip, ix, av[i] if over == "A" else av, bip, bix,
                    bv[i] if over == "B" else bv, n, b_sorted=True)
                for i in range(size)],
                "per_member_instance": lambda: k6_batched_at(args, 1)},
            device_match=("spgemm_dense_kernel",
                          "spgemm_dense_group_kernel"),
            members=size, case="a", group=spgemm.dense_group(
                av.dtype, ix.element_size(), size,
                spgemm.dense_form(over == "A", over == "B"))))
        del av, bv
    if groups_only:
        A = formats.to_device(inp["a1m"])
        a = A.csr_arrays()
        c = spgemm.csr_spgemm(*a, *a, inp["a1m"].shape[1])[:2]
        rows.append(k5_batched_row(shape_c, inp["a1m"], inp["a1m"], a, a, c,
                                   rng, "c"))
        del A, a, c
        return over_single_launches(rows + [k5_case_h_row(rng)])
    g = cuda(values(rng, (4, n, n), np.float64))
    t, order = formats.CsrPattern(ip, ix, x.shape[1]).transpose()
    for transposed in (False, True):
        args = ((bip, bix, g, t.indptr, t.indices, dv[order], None, True)
                if transposed else (ip, ix, g, bip, bix, bdv, None, False))
        rows.append(timed_row(
            "K9_csr_spgemm_sddmm",
            f"batched: {shape_a}, 4 G's ({n},{n}), "
            f"{'dL/dB' if transposed else 'dL/dA'}, values shared",
            lambda: spgemm_grad.sampled_batched(*args),
            lambda: spgemm_grad.csr_spgemm_sddmm_batched_plain(*args),
            k9_batched_bound(args, 4),
            beside={"4_single_launches": lambda: [
                spgemm_grad.csr_spgemm_sddmm(*args[:2], args[2][i],
                                             *args[3:])
                for i in range(4)]},
            device_match=K9_DEVICE_NAMES + GATHER_NAMES, members=4,
            group=sampled_group(k9_plan(g[0], *args[3:5], transposed), g,
                                True),
            case="a-dB" if transposed else "a-dA"))
    del g, A, B
    for case, shape, a_np, b_np in (
            ("a", shape_a + ", sparse output", x, x.T.tocsr()),
            ("c", shape_c, inp["a1m"], inp["a1m"])):
        A, B = formats.to_device(a_np), formats.to_device(b_np)
        a, b = A.csr_arrays(), B.csr_arrays()
        n = b_np.shape[1]
        c = spgemm.csr_spgemm(*a, *b, n)[:2]
        g = cuda(values(rng, (4, c[1].numel()), np.float64))
        # The patterns as CsrSpgemmSparseSddmm gives them (C's column span
        # known: no host read), to the batched and the single calls.
        pats = {"a": autograd.patterns.get(a[0], a[1], b[0].numel() - 1),
                "b": autograd.patterns.get(b[0], b[1], n),
                "c": formats.CsrPattern(c[0], c[1], n, span=(0, n))}
        for transposed in (False, True):
            args = (*a, *b, *c, g, n, transposed)
            first = max(tt[0] for tt in time_turns({
                "kernel": lambda: spgemm_grad.sparse_sampled_batched(
                    *args, **pats),
                "plain": lambda: spgemm_grad
                .csr_spgemm_sparse_sddmm_batched_plain(*args)}, 1).values())
            rows.append(timed_row(
                "K11_csr_spgemm_sparse_sddmm",
                f"batched: {shape}, 4 G's on C's pattern, "
                f"{'dL/dB' if transposed else 'dL/dA'}, values shared",
                lambda: spgemm_grad.sparse_sampled_batched(*args, **pats),
                lambda: spgemm_grad.csr_spgemm_sparse_sddmm_batched_plain(
                    *args),
                k11_batched_bound(a, b, c, g, transposed, 4),
                (None, "none: torch has no sampled product of two sparse "
                       "operands at a sparse pattern"),
                reps=REPS if first <= 50 else 5,
                beside={"4_single_launches": lambda: [
                    spgemm_grad.sparse_sampled(*args[:8], g[i], *args[9:],
                                               **pats)
                    for i in range(4)]},
                device_match=K11_DEVICE_NAMES + GATHER_NAMES, members=4,
                group=sampled_group(k11_plan(a, b, g, n, transposed), g,
                                    True, transposed),
                case=f"{case}-{'dB' if transposed else 'dA'}"))
        del pats
        autograd.patterns.clear()
        if case == "c":
            rows.append(k5_batched_row(shape, a_np, b_np, a, b, c, rng, "c"))
        del A, B, a, b, c, g
        torch.cuda.empty_cache()
    rows.append(k5_case_h_row(rng))
    return over_single_launches(rows)


def over_single_launches(rows):
    """``rows`` with each row's ms (and device ms) over its beside single
    launches' and, where timed, over the per-member instance's."""
    for row in rows:
        (name, single), = ((k, v) for k, v in row["beside"].items()
                           if k.endswith("_single_launches"))
        row["ms_over_single_launches"] = row["ms"] / single["ms"]
        if "per_member_instance" in row["beside"]:
            row["ms_over_per_member_instance"] = (
                row["ms"] / row["beside"]["per_member_instance"]["ms"])
        device = row.get("device_ms") or {}
        if device.get("kernel") and device.get(name):
            row["device_over_single_launches"] = (device["kernel"]
                                                  / device[name])
    return rows


# ---------------------------------------------------------------------------
# Phase 5: the solver path
# ---------------------------------------------------------------------------


def grid_matrix(side, shift, convection=0.0):
    """The 5-point Laplacian of a side x side grid (Dirichlet) plus
    shift * I, f64 CSR; with ``convection`` c, first-order upwind
    convection along the grid's x axis (+c on the diagonal, -c on the west
    neighbour), which makes it nonsymmetric."""
    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    eye = sps.eye(side)
    a = sps.kron(eye, t) + sps.kron(t, eye) + shift * sps.eye(side * side)
    if convection:
        a = a + convection * sps.kron(
            eye, sps.diags([-1.0, 1.0], [-1, 0], shape=(side, side)))
    return a.tocsr()


def with_identity_tail(a):
    """``a`` (m x k) plus the identity in its last k rows: full column
    rank."""
    m, k = a.shape
    tail = sps.csr_matrix((np.ones(k), (np.arange(m - k, m), np.arange(k))),
                          shape=(m, k))
    return (a + tail).tocsr()


def solver_inputs():
    rng = np.random.default_rng(SEED + 3)
    side = SIZES["grid"]
    n = side * side
    x = demo_x()
    # The demo X with the entries of each row in a random order.
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    order = np.lexsort((rng.random(x.nnz), rows))
    x_shuffled = sps.csr_matrix((x.data[order], x.indices[order], x.indptr),
                                shape=x.shape)
    # BASELINE config 5 ("1M+-row" least squares), on one chip.
    cgls_nnz = 4_650_000
    cgls_a = with_identity_tail(sps.csr_matrix(
        (rng.standard_normal(cgls_nnz),
         (rng.integers(0, 1_200_000, cgls_nnz),
          rng.integers(0, 50_000, cgls_nnz))), shape=(1_200_000, 50_000)))
    lap = grid_matrix(side, 0.01)
    lu_spd = grid_matrix(63, 0.01)
    return {
        "x": x, "x_shuffled": x_shuffled,
        "lap": lap, "lap_upper": sps.triu(lap, format="csr"),
        "cd": grid_matrix(side, 0.05, convection=0.5),
        "b": rng.standard_normal(n),
        "b16": rng.standard_normal((n, 16)),
        "qr_a": with_identity_tail(sps.random(
            20_000, 500, density=0.01, format="csr", random_state=rng)),
        "qr_b": rng.standard_normal(20_000),
        "cgls_a": cgls_a, "cgls_b": rng.standard_normal(cgls_a.shape[0]),
        "lu_a": random_coo_csr(rng, 12_000, 120_000) + 10.0 * sps.eye(12_000),
        "lu_b": rng.standard_normal(12_000),
        "lu_b4": rng.standard_normal((12_000, 4)),
        "lu_c": (random_coo_csr(rng, 4000, 40_000)
                 + 1j * random_coo_csr(rng, 4000, 40_000)
                 + 10.0 * sps.eye(4000)).tocsr(),
        "lu_cb": rng.standard_normal(4000) + 1j * rng.standard_normal(4000),
        "lu_spd": lu_spd, "lu_spd_upper": sps.triu(lu_spd, format="csr"),
        "lu_spd_b": rng.standard_normal(63 * 63),
        "cgls_b4": rng.standard_normal((cgls_a.shape[0], 4)),
    }


class count_syncs:
    """Counts the host syncs inside the block: the warnings that
    ``torch.cuda.set_sync_debug_mode("warn")`` raises.  Other warnings are
    kept in ``other``."""

    def __enter__(self):
        self.catcher = warnings.catch_warnings(record=True)
        self.records = self.catcher.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.catcher.__exit__(*exc)
        sync = [r for r in self.records
                if "called a synchronizing" in str(r.message)]
        self.count = len(sync)
        self.other = [r for r in self.records if r not in sync]
        return False


def device_busy_ms(fn):
    """The device time of what fn() runs on the card (kernels, copies and
    fills), summed from a ``torch.profiler`` trace, in ms; None when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU)
    return busy / 1e3 or None


def kernel_device_ms(fn, match, reps=10):
    """The mean device time in ms of the kernels whose names hold
    ``match`` (or one of a tuple of names) in a call of fn(), from a ``torch.profiler`` trace of
    ``reps`` calls, each after a 1 GiB read (as ``time_turns``): the
    kernels' own time, whatever the host does between launches; None when
    the trace holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(256 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    names = (match,) if isinstance(match, str) else match
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and any(name in e.key for name in names))
    return busy / 1e3 / reps or None


def rel_residual(a, x, b):
    """max over columns of ||b - a x|| / ||b||."""
    r = b - a @ x
    return float(np.max(np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)))


def normal_residual(a, x, b):
    """||A^T (A x - b)||_inf / ||A^T b||_inf, the largest over columns
    (phase 5's least-squares check)."""
    grad = np.abs(a.T @ (a @ x - b)).max(axis=0)
    return float(np.max(grad / np.abs(a.T @ b).max(axis=0)))


def solver_path(inp):
    """The handle protocol and the solvers through the public API, each
    call's launches, syncs and wall time recorded, each result checked."""
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch import interface
    from sparse_dot_tpu_torch.solvers import qr

    lap, cd, b = inp["lap"], inp["cd"], inp["b"]
    records = {}

    def run(name, kernels, fn, warns=None):
        """fn() with syncs counted, checking that exactly the kernels in
        ``kernels`` launched; then SOLVE_REPS more calls for the wall times
        (median, min, max) and one under the profiler for the device's
        busy time and idle share.  Returns the first call's result."""
        before = read_launches()
        with count_syncs() as syncs:
            t0 = time.perf_counter()
            out = fn()
            first = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in read_launches().items()
                    if v != before[k]}
        if set(launched) != set(kernels):
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"{kernels}")
        for r in syncs.other:
            if not (warns and issubclass(r.category, warns)):
                raise AssertionError(f"{name}: warned {r.message}")
        walls = []
        with warnings.catch_warnings():
            if warns:
                warnings.simplefilter("ignore", warns)
            for _ in range(SOLVE_REPS):
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            busy = device_busy_ms(fn)
        wall = float(np.median(walls))
        records[name] = {
            "wall_ms": wall, "wall_min_ms": min(walls),
            "wall_max_ms": max(walls), "first_wall_ms": first,
            "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall,
            "syncs": syncs.count, "launches": launched}
        return out

    def cg(a, descr=None, max_iter=1000, stepwise=False):
        with sdt.CGIterativeSparseSolver(a, b, r_tol=1e-5,
                                         max_iter=max_iter) as s:
            if descr:
                s.set_sparse_matrix_descr(*descr)
            if stepwise:
                for _ in s:
                    pass
                return s.x, s.current_iter, s.final_code
            return s.solve(), s.current_iter, s.final_code

    def fgmres():
        with sdt.FGMRESIterativeSparseSolver(cd, b, r_tol=1e-5) as s:
            s.restart = 20
            return (s.solve(), s.current_iter, s.total_inner_iterations,
                    s.final_code)

    def handles():
        h = interface.convert_to_csr(
            interface.create_sparse_handle(inp["x"].tocsc())[0])
        ordered = interface.order_sparse_handle(
            interface.create_sparse_handle(inp["x_shuffled"])[0])
        product = interface.matmul_handles(
            h, interface.create_sparse_handle(inp["x"].T)[0])
        return [interface.export_sparse_handle(hh)
                for hh in (h, ordered, product)]

    def pardiso(a, rhs, mtype, tmode=0, then=None):
        pt, iparm = sdt.pardisoinit(mtype)
        iparm[11] = tmode
        X, pt, _, err = sdt.pardiso(a, rhs, pt, mtype, iparm, 13)
        out = [X, err]
        if then is not None:
            X2, pt, _, err2 = sdt.pardiso(a, then, pt, mtype, iparm, 33)
            out += [X2, err2]
        sdt.pardiso(a, rhs, pt, mtype, iparm, -1)
        return out

    sym = (interface.SPARSE_MATRIX_TYPE_SYMMETRIC,
           interface.SPARSE_FILL_MODE_UPPER, interface.SPARSE_DIAG_NON_UNIT)
    # matmul_handles(X, X.T) of two handles (two operands): the structural
    # densify route where the gate sends it, else K4 + K5.
    x = inp["x"]
    handle_kernels = (
        ("K12_csr_densify", "K12_csr_indicator", "K13_csr_compact")
        if sparse_dense_route(*x.shape, x.shape[0], x.nnz, x.nnz,
                              torch.float64, False)
        else ("K4_csr_spgemm_count", "K5_csr_spgemm_fill"))
    reset_launches()
    with plain_versions_refused():
        conv, ordered, product = run("handles", handle_kernels, handles)
        x_cg, it_cg, code_cg = run("cg", ("K3_csr_spmv",), lambda: cg(lap))
        x_sym, it_sym, code_sym = run("cg_symmetric_triangle",
                                      ("K3_csr_spmv",),
                                      lambda: cg(inp["lap_upper"], sym))
        x20f, it20f, _ = run("cg_fused_20", ("K3_csr_spmv",),
                             lambda: cg(lap, max_iter=20),
                             warns=sdt.ConvergenceWarning)
        x20s, it20s, _ = run("cg_stepwise_20", ("K3_csr_spmv",),
                             lambda: cg(lap, max_iter=20, stepwise=True))
        X16, codes16 = run("cg_mrhs_16", ("K2_csr_spmm",),
                           lambda: sdt.cg_mrhs(lap, inp["b16"]))
        x_fg, cycles, inner, code_fg = run("fgmres_20", ("K3_csr_spmv",),
                                           fgmres)
        x_qr = run("qr_householder_20000x500", ("K12_csr_densify",),
                   lambda: sdt.sparse_qr_solve(inp["qr_a"], inp["qr_b"]))
        x_cgls = run("qr_cgls_1.2Mx50k", ("K3_csr_spmv",),
                     lambda: sdt.sparse_qr_solve(inp["cgls_a"],
                                                 inp["cgls_b"]))
        cgls_iters = qr._last_cgls_iters
        x_cgls4 = run("qr_cgls_1.2Mx50k_4rhs", ("K2_csr_spmm",),
                      lambda: sdt.sparse_qr_solve(inp["cgls_a"],
                                                  inp["cgls_b4"]))
        cgls4_iters = qr._last_cgls_iters
        lu = run("pardiso_lu_12000_f64", ("K12_csr_densify",),
                 lambda: pardiso(inp["lu_a"], inp["lu_b"], 11,
                                 then=inp["lu_b4"]))
        lu_c = run("pardiso_lu_4000_c128_transpose", ("K12_csr_densify",),
                   lambda: pardiso(inp["lu_c"], inp["lu_cb"], 13, tmode=2))
        lu_spd = run("pardiso_lu_3969_spd_triangle", ("K12_csr_densify",),
                     lambda: pardiso(inp["lu_spd_upper"], inp["lu_spd_b"], 2))
        kry = run("pardiso_krylov_1M_spd", ("K3_csr_spmv",),
                  lambda: pardiso(lap, b, 2), warns=RuntimeWarning)
    launches = read_launches()

    # Checks against scipy/numpy on the host.
    x = inp["x"]
    for name, got in (("convert_csc", conv), ("order", ordered)):
        if not (np.array_equal(got.indptr, x.indptr)
                and np.array_equal(got.indices, x.indices)
                and np.array_equal(got.data, x.data)):
            raise AssertionError(f"handles {name}: arrays differ from X")
    cases = {}
    check_sparse(cases, "handles_x_xT", product, x @ x.T, 6, pattern=True)
    oracle = {"handles_x_xT": cases["handles_x_xT"]["max_abs_err"]}
    for name, got, it, code in (("cg", x_cg, it_cg, code_cg),
                                ("cg_symmetric_triangle", x_sym, it_sym,
                                 code_sym)):
        oracle[name] = rel_residual(lap, got, b)
        if code != 0 or not oracle[name] <= 1e-5:
            raise AssertionError(f"{name}: code {code}, {oracle[name]}")
        records[name]["iterations"] = it
    if not (it20f == it20s == 20 and np.array_equal(x20f, x20s)):
        raise AssertionError(f"CG fused and stepwise differ: {it20f} "
                             f"{it20s} {np.abs(x20f - x20s).max()}")
    oracle["cg_fused_vs_stepwise_20"] = float(np.abs(x20f - x20s).max())
    records["cg_fused_20"]["iterations"] = it20f
    records["cg_stepwise_20"]["iterations"] = it20s
    # Steps issued: the fused loops run up to CHECK_EVERY - 1 frozen steps
    # past convergence, and one matvec (K3) or product (K2) for r0.
    for name, kernel in (("cg", "K3_csr_spmv"),
                         ("cg_symmetric_triangle", "K3_csr_spmv"),
                         ("cg_mrhs_16", "K2_csr_spmm"),
                         ("pardiso_krylov_1M_spd", "K3_csr_spmv")):
        records[name]["issued_steps"] = records[name]["launches"][kernel] - 1
    records["cg_mrhs_16"]["iterations"] = records["cg_mrhs_16"][
        "issued_steps"]
    records["pardiso_krylov_1M_spd"]["iterations"] = records[
        "pardiso_krylov_1M_spd"]["issued_steps"]
    oracle["cg_mrhs_16"] = rel_residual(lap, X16, inp["b16"])
    if codes16.any() or not oracle["cg_mrhs_16"] <= 1e-5:
        raise AssertionError(f"cg_mrhs: codes {codes16}")
    oracle["fgmres_20"] = rel_residual(cd, x_fg, b)
    if code_fg != 0 or not oracle["fgmres_20"] <= 1e-5:
        raise AssertionError(f"fgmres: code {code_fg}, {oracle['fgmres_20']}")
    records["fgmres_20"].update(iterations=inner, cycles=cycles,
                                matvecs=cycles * 21 + 1)
    ref = np.linalg.lstsq(inp["qr_a"].toarray(), inp["qr_b"], rcond=None)[0]
    np.testing.assert_array_almost_equal(x_qr, ref, decimal=6)
    oracle["qr_householder_20000x500"] = float(np.abs(x_qr - ref).max())
    a = inp["cgls_a"]
    for name, got, bb, iters in (
            ("qr_cgls_1.2Mx50k", x_cgls, inp["cgls_b"], cgls_iters),
            ("qr_cgls_1.2Mx50k_4rhs", x_cgls4, inp["cgls_b4"], cgls4_iters)):
        oracle[name] = normal_residual(a, got, bb)
        if not oracle[name] <= 1e-6:
            raise AssertionError(f"{name}: normal-equation residual "
                                 f"{oracle[name]}")
        records[name]["iterations"] = iters
    lu_full = sps.triu(inp["lu_spd"]) + sps.triu(inp["lu_spd"], k=1).T
    for name, got, a, rhs, limit in (
            ("pardiso_lu_12000_f64", lu[0], inp["lu_a"], inp["lu_b"], 1e-10),
            ("pardiso_lu_12000_f64_phase33", lu[2], inp["lu_a"],
             inp["lu_b4"], 1e-10),
            ("pardiso_lu_4000_c128_transpose", lu_c[0], inp["lu_c"].T,
             inp["lu_cb"], 1e-10),
            ("pardiso_lu_3969_spd_triangle", lu_spd[0], lu_full,
             inp["lu_spd_b"], 1e-10),
            ("pardiso_krylov_1M_spd", kry[0], lap, b, 1e-9)):
        oracle[name] = rel_residual(a, got, rhs)
        if not oracle[name] <= limit:
            raise AssertionError(f"{name}: relative residual {oracle[name]}")
    if any(err for err in (lu[1], lu[3], lu_c[1], lu_spd[1], kry[1])):
        raise AssertionError("a pardiso phase returned an error")
    emit(5, launches=launches, solves=records, oracle=oracle,
         limits={"cg, cg_mrhs, fgmres": "||b - A x|| <= 1e-5 ||b||",
                 "qr_cgls": "||A^T(Ax - b)||_inf <= 1e-6 ||A^T b||_inf",
                 "qr_householder": "np.linalg.lstsq, decimal=6",
                 "pardiso_lu": "||b - op(A) x|| <= 1e-10 ||b||",
                 "pardiso_krylov": "||b - A x|| <= 1e-9 ||b||"})
    return launches, records


# ---------------------------------------------------------------------------
# Phase 6: the training path (the device API under autograd)
# ---------------------------------------------------------------------------

# Loss tolerance of "at or below the previous one, up to rounding".
LOSS_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5,
             torch.complex128: 1e-12}


def squares(d):
    """sum |d|^2, a real loss for real and complex ``d``."""
    return (torch.view_as_real(d) if d.is_complex() else d).square().sum()


def power_norm_sq(b, iters=30):
    """||b||_2^2 from ``iters`` power iterations on b^H b, on the card."""
    v = torch.ones(b.shape[1], dtype=b.dtype, device=b.device)
    for _ in range(iters):
        w = b.mH @ (b @ v)
        v = w / torch.linalg.vector_norm(w)
    return float(torch.linalg.vector_norm(b @ v)) ** 2


def coo_of(a):
    """(rows, cols) of a scipy CSR on the card, int32, in its stored
    order."""
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    return cuda(rows.astype(np.int32)), cuda(a.indices.astype(np.int32))


def host_norm_sq(a, iters=30):
    """||a||_2^2 of a scipy matrix from ``iters`` power iterations on
    a^H a, on the host."""
    v = np.ones(a.shape[1])
    ah = a.conj().T
    for _ in range(iters):
        w = ah @ (a @ v)
        v = w / np.linalg.norm(w)
    return float(np.linalg.norm(a @ v)) ** 2


class GradRun:
    """SGD on ``params`` (each with its step in ``lrs``) of
    loss = ||fn(*params) - target||^2, ``fn`` through the port's
    Functions, whose result must carry the node ``node``; at the first
    and the last step the parameters and gradients are kept, and
    ``check`` holds them against torch's own gradients of the same loss
    through ``plain``, the plain versions.  Each step is timed on the
    host clock to a synchronize."""

    def __init__(self, name, fn, plain, params, lrs, target, node):
        self.name, self.fn, self.plain, self.node = name, fn, plain, node
        self.target = target
        self.params = [p.detach().clone().requires_grad_() for p in params]
        self.opt = torch.optim.SGD([{"params": [p], "lr": lr}
                                    for p, lr in zip(self.params, lrs)])
        self.losses, self.walls, self.kept = [], [], []

    def step(self, keep=False, target=None, **kw):
        """One step (``kw`` to ``fn``, and ``target`` for this step's
        loss when given); returns the loss."""
        target = self.target if target is None else target
        self.opt.zero_grad(set_to_none=True)
        out = self.fn(*self.params, **kw)
        if type(out.grad_fn).__name__ != self.node:
            raise AssertionError(f"{self.name}: node {out.grad_fn}")
        loss = squares(out - target)
        loss.backward()
        if keep:
            self.kept.append((kw, target,
                              [p.detach().clone() for p in self.params],
                              [p.grad.clone() for p in self.params]))
        self.opt.step()
        torch.cuda.synchronize()
        return loss.detach()

    def run(self, steps):
        for i in range(steps):
            t0 = time.perf_counter()
            self.losses.append(self.step(keep=i in (0, steps - 1)))
            self.walls.append((time.perf_counter() - t0) * 1e3)

    def check(self):
        """Finite losses, each at or below the one before up to rounding;
        every kept step's gradients against torch's through the plain
        versions.  Returns the run's record."""
        losses = torch.stack(self.losses).cpu().tolist()
        rtol = LOSS_RTOL[self.params[0].dtype]
        if not all(np.isfinite(losses)) or any(
                b > a * (1 + rtol) for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"{self.name}: losses {losses}")
        err = [0.0] * len(self.params)
        for kw, target, params, grads in self.kept:
            ps = [p.clone().requires_grad_() for p in params]
            loss = squares(self.plain(*ps, **kw) - target)
            for i, (g, ref) in enumerate(zip(
                    grads, torch.autograd.grad(loss, ps))):
                err[i] = max(err[i], compare(g, ref, ref.dtype))
        return {"steps": len(losses), "first_loss": losses[0],
                "last_loss": losses[-1], "losses": losses,
                "step_wall_ms": float(np.median(self.walls[1:])),
                "step_wall_min_ms": min(self.walls[1:]),
                "step_wall_max_ms": max(self.walls[1:]),
                "first_step_wall_ms": self.walls[0],
                "max_abs_err_vs_plain": err,
                "kept_steps": [kw for kw, *_ in self.kept]}


def profiled(run):
    """The device's busy ms of one more step of ``run`` in a
    ``torch.profiler`` trace (not one of the run's steps) and its idle
    share against the run's median step."""
    busy = device_busy_ms(run.step)
    wall = float(np.median(run.walls[1:]))
    return {"step_device_busy_ms": busy,
            "step_device_idle_share": None if busy is None
            else 1 - busy / wall}


def coo_run(name, rows, cols, m, b, target, dtype, lr, train_b=False,
            spmv=False):
    """A ``GradRun`` of SGD through ``ops.coo_spmm_raw`` (``coo_spmv``
    with ``spmv``) from zero values toward ``target``, on the values and,
    with ``train_b``, on b too, each with step ``lr``; the plain reference
    is ``csr_spmm_plain`` (``csr_spmv_plain``) on the COO's CSR form."""
    from sparse_dot_tpu_torch.ops import autograd, csr

    device_fn = autograd.coo_spmv if spmv else autograd.coo_spmm_raw
    plain_fn = csr.csr_spmv_plain if spmv else csr.csr_spmm_plain
    pattern = autograd.structures.get(rows, cols, m, b.shape[0])
    b = b.to(dtype)

    def fn(v, bb=b):
        return device_fn(rows, cols, v, bb, m)

    def plain(v, bb=b):
        return plain_fn(pattern.pattern.indptr, pattern.pattern.indices,
                        v[pattern.order], bb)

    vals = torch.zeros(rows.numel(), dtype=dtype, device=rows.device)
    params = (vals, b) if train_b else (vals,)
    return GradRun(name, fn, plain, params, (lr,) * len(params),
                   target.to(dtype),
                   "CsrSpmvBackward" if spmv else "CsrSpmmBackward")


def config1_problem(inputs):
    """Phase 6's problem on config 1: A's COO (rows, cols), m, B and the
    target T = A B on the card, and the step 1/L, L = 2 ||B||_2^2 from
    power iterations."""
    a1 = inputs["a1"]
    b1 = cuda(inputs["b1"])
    r1, c1 = coo_of(a1)
    return (r1, c1, a1.shape[0], b1, cuda(a1 @ inputs["b1"]),
            1.0 / (2.0 * power_norm_sq(b1)))


def training_path(inputs):
    """Phase 6: SGD through the device API at full width with the plain
    versions refused.  Config 1's pattern (10,000^2, 1%) and phase 3's B
    (10,000 x 128): 20 steps in f64 on the values (K2, K7), with step 1/L,
    L = 2 ||B||_2^2 from power iterations; 20 in f32 with B trained too
    (K2 over A^H as well); 10 steps of the SpMV form on the 1M^2 matrix
    with x trained too (K3, K7 at n = 1, K3 over A^H; L = 2 max over rows
    of ||x at the row's columns||^2); one step through ``torch.func.vmap``
    over 4 right-hand sides of 32 columns (K2 once, K7 once); the batched
    launches, one a ``vmap`` level: ``vmap`` of ``grad`` over 3
    right-hand sides (K2 once, folded; K7 once, batched) and ``vmap``
    over 3 sets of values (K2 once, batched), against the plain
    versions; one more f64
    step under ``torch.profiler`` for the device's busy time.  Checks the
    losses, the grad_fn of every result and, at the first and last step of
    each run, the gradients against the plain versions."""
    from sparse_dot_tpu_torch.ops import autograd, csr, sddmm

    av = inputs["av"]
    mv = av.shape[0]
    xv = cuda(inputs["xv"])
    tv = cuda(av @ inputs["xv"])
    r1, c1, m1, b1, t1, lr1 = config1_problem(inputs)
    rv, cv = coo_of(av)
    row_sq = torch.zeros(mv, dtype=torch.float64, device=xv.device).index_add_(
        0, rv, xv[cv.long()] ** 2)
    lrv = 1.0 / (2.0 * float(row_sq.max()))
    runs = {
        "f64_values": coo_run("f64_values", r1, c1, m1, b1, t1,
                              torch.float64, lr1),
        "f32_values_and_b": coo_run("f32_values_and_b", r1, c1, m1, b1, t1,
                                    torch.float32, lr1, train_b=True),
        "spmv_f64_values_and_x": coo_run(
            "spmv_f64_values_and_x", rv, cv, mv, xv, tv, torch.float64, lrv,
            train_b=True, spmv=True),
    }
    steps = {"f64_values": 20, "f32_values_and_b": 20,
             "spmv_f64_values_and_x": 10}
    bs = b1.view(m1, 4, 32).permute(1, 0, 2)
    ts = t1.view(m1, 4, 32).permute(1, 0, 2)

    reset_launches()
    with plain_versions_refused():
        t0 = time.perf_counter()
        for name, run in runs.items():
            run.run(steps[name])
        seconds = time.perf_counter() - t0
        # One step through vmap over 4 right-hand sides.
        v = runs["f64_values"].params[0].detach().clone().requires_grad_()
        k2_before = read_launches()["K2_csr_spmm"]
        cv4 = torch.func.vmap(
            lambda b: autograd.coo_spmm_raw(r1, c1, v, b, m1))(bs)
        vmap_k2 = read_launches()["K2_csr_spmm"] - k2_before
        if cv4.grad_fn is None or vmap_k2 != 1:
            raise AssertionError(f"vmap step: K2 launched {vmap_k2} times")
        ((cv4 - ts) ** 2).sum().backward()
        # The batched launches, one a vmap level: gradients of 3 members'
        # losses through ``vmap`` of ``grad`` over b (K2 once, folded; K7
        # once, batched), and a batch of 3 values (K2 once, batched).
        before = read_launches()
        v0 = v.detach()
        member_grads = torch.func.vmap(
            torch.func.grad(lambda vv, b, t: ((autograd.coo_spmm_raw(
                r1, c1, vv, b, m1) - t) ** 2).sum()),
            in_dims=(None, 0, 0))(v0, bs[:3], ts[:3])
        vs = torch.stack([v0, 0.5 * v0, -v0])
        member_out = torch.func.vmap(
            lambda vv: autograd.coo_spmm_raw(r1, c1, vv, bs[0], m1))(vs)
        after = read_launches()
        member_launches = {
            name: after[name] - before[name]
            for name in ("K2_csr_spmm", "K7_csr_sddmm")}
        if member_launches != {"K2_csr_spmm": 2, "K7_csr_sddmm": 1}:
            raise AssertionError(f"batched vmap: {member_launches}")
        torch.cuda.synchronize()
        busy = profiled(runs["f64_values"])
    launches = read_launches()
    expected = {name: 0 for name in launches}
    expected.update(K2_csr_spmm=20 + 40 + 1 + 2 + 1, K3_csr_spmv=20,
                    K7_csr_sddmm=20 + 20 + 10 + 1 + 1 + 1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    records = {name: run.check() for name, run in runs.items()}
    s = autograd.structures.get(r1, c1, m1, b1.shape[0])
    g = 2 * (cv4.detach().permute(1, 0, 2).reshape(m1, 128) - t1)
    ref = sddmm.csr_sddmm_plain(s.pattern.indptr, s.pattern.indices, g, b1)
    vmap_err = compare(v.grad[s.order], ref, ref.dtype)
    member_err = {"grad": 0.0, "values": 0.0}
    b_cols = bs[0].contiguous()
    for i in range(3):
        b_i = bs[i].contiguous()
        g_i = 2 * (csr.csr_spmm_plain(s.pattern.indptr, s.pattern.indices,
                                      v0[s.order], b_i) - ts[i])
        ref = sddmm.csr_sddmm_plain(s.pattern.indptr, s.pattern.indices,
                                    g_i, b_i)
        member_err["grad"] = max(member_err["grad"], compare(
            member_grads[i][s.order], ref, ref.dtype))
        ref = csr.csr_spmm_plain(s.pattern.indptr, s.pattern.indices,
                                 vs[i][s.order], b_cols)
        member_err["values"] = max(member_err["values"], compare(
            member_out[i], ref, ref.dtype))
    emit(6, seconds=seconds, launches=launches, runs=records,
         lr={"config1": lr1, "spmv": lrv},
         vmap_step={"k2_launches": vmap_k2, "max_abs_err_vs_plain": vmap_err},
         batched_vmap={"launches": member_launches,
                          "max_abs_err_vs_plain": member_err},
         f64_step_device_busy_ms=busy["step_device_busy_ms"],
         f64_step_device_idle_share=busy["step_device_idle_share"],
         timer="host clock per step to a synchronize, median of steps "
               "2..N; device busy: torch.profiler, one more f64 step")
    return launches


def k7_training(inputs):
    """Phase 6 for K7 alone (``--only k7``): training_path's 20 f64 SGD
    steps on config 1's values (K2 forward, K7 backward) with the plain
    versions refused, checked as there, and the device's busy ms of one
    more step in a ``torch.profiler`` trace."""
    r1, c1, m1, b1, t1, lr1 = config1_problem(inputs)
    run = coo_run("f64_values", r1, c1, m1, b1, t1, torch.float64, lr1)
    reset_launches()
    with plain_versions_refused():
        run.run(20)
        busy = profiled(run)
    launches = read_launches()
    expected = {name: 0 for name in launches}
    expected.update(K2_csr_spmm=21, K7_csr_sddmm=21)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    emit(6, launches=launches, runs={"f64_values": run.check()},
         lr={"config1": lr1},
         f64_step_device_busy_ms=busy["step_device_busy_ms"],
         f64_step_device_idle_share=busy["step_device_idle_share"],
         timer="host clock per step to a synchronize, median of steps "
               "2..N; device busy: torch.profiler, one more f64 step")


# Phase 6's runs of the BSR device function and of the dense-output
# sparse x sparse product: steps, and each kernel's launches a step.
BSR_STEPS, SPGEMM_STEPS, BSR_SIMT_STEPS, BSR_COMPLEX_STEPS = 15, 10, 5, 5


def bsr_run(name, a, b_np):
    """A ``GradRun`` of SGD through ``ops.bsr_spmm`` on the scipy BSR
    ``a``'s pattern (in its value type) and ``b_np``, both trained, from
    zero blocks toward T = A b, with steps 1/(2 ||b||^2) for the blocks
    and 1/(4 ||A||^2) for b.  Returns (run, steps)."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, bsr

    bs = a.blocksize[0]
    m, k = a.shape
    rows = np.repeat(np.arange(m // bs), np.diff(a.indptr))
    r3, c3 = cuda(rows.astype(np.int32)), cuda(a.indices.astype(np.int32))
    b = cuda(b_np)
    target = cuda(a @ b_np)
    lrs = (1.0 / (2.0 * power_norm_sq(b)), 0.25 / host_norm_sq(a))
    blocks = torch.zeros(a.data.shape, dtype=b.dtype, device=b.device)

    def plain(d, bb):
        p = autograd.bsr_structures.get(r3, c3, m, k, bs)
        return bsr.bsr_spmm_plain(p.indptr, p.indices, d[p.order], bb)

    return GradRun(name, lambda d, bb: ops.bsr_spmm(d, r3, c3, bb, m),
                   plain, (blocks, b), lrs, target, "BsrSpmmBackward"), lrs


def bsr_training(inputs):
    """SGD through ``ops.bsr_spmm`` on config 3's pattern (8192^2, bs 64,
    5% of blocks, f64) and phase 3's b (8192 x 256), both trained: K1
    forward on the tensor cores, K8 (tensor cores) and K1 over A^H
    backward; then BSR_SIMT_STEPS steps on a 4000^2 f64 BSR of 20 x 20
    blocks (5%) and a b of 64 columns, made from SEED + 14, which K1 and
    K8 serve on the CUDA cores; then BSR_COMPLEX_STEPS steps on a 4000^2
    c128 BSR of 16 x 16 blocks (5%) and a b of 64 columns, made from
    SEED + 33, which K1 and K8 serve on the tensor cores' complex
    instances (K1 forward and over A^H, K8 in BsrSpmm's backward); the
    plain versions refused.  Returns the launches and the runs'
    records."""
    run, lrs = bsr_run("bsr_f64_blocks_and_b", inputs["bsrs"][(64, np.float64)],
                       inputs["b3"][np.float64])
    reset_launches()
    with plain_versions_refused():
        run.run(BSR_STEPS)
        busy = profiled(run)
    launches = read_launches()
    expected = {name: 0 for name in launches}
    expected.update(K1_bsr_spmm_tc=2 * (BSR_STEPS + 1),
                    K8_bsr_sddmm_tc=BSR_STEPS + 1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    record = {**run.check(), **busy, "lr": list(lrs)}

    rng = np.random.default_rng(SEED + 14)
    small, lrs = bsr_run("bsr_f64_bs20_blocks_and_b",
                         config3_bsr(rng, 4000, np.float64, 20),
                         values(rng, (4000, 64), np.float64))
    reset_launches()
    with plain_versions_refused():
        small.run(BSR_SIMT_STEPS)
    got = read_launches()
    expected = {name: 0 for name in got}
    expected.update(K1_bsr_spmm_simt=2 * BSR_SIMT_STEPS,
                    K8_bsr_sddmm_simt=BSR_SIMT_STEPS)
    if got != expected:
        raise AssertionError(f"launch counts {got}, expected {expected}")
    launches = {name: launches[name] + got[name] for name in launches}
    records = {"config3_bs64": record,
               "bs20": {**small.check(), "lr": list(lrs)}}

    rng = np.random.default_rng(SEED + 33)
    cplx, lrs = bsr_run("bsr_c128_bs16_blocks_and_b",
                        config3_bsr(rng, 4000, np.complex128, 16),
                        values(rng, (4000, 64), np.complex128))
    reset_launches()
    with plain_versions_refused():
        cplx.run(BSR_COMPLEX_STEPS)
    got = read_launches()
    expected = {name: 0 for name in got}
    expected.update(K1_bsr_spmm_tc_complex=2 * BSR_COMPLEX_STEPS,
                    K8_bsr_sddmm_tc_complex=BSR_COMPLEX_STEPS)
    if got != expected:
        raise AssertionError(f"launch counts {got}, expected {expected}")
    launches = {name: launches[name] + got[name] for name in launches}
    records["c128_bs16"] = {**cplx.check(), "lr": list(lrs)}
    return launches, records


def spgemm_training(x):
    """SGD through ``csr_spgemm_dense`` on the demo X (500 x 5000, 21.2%,
    f64): op(A) = X's values, from zero, and op(B) = a separate copy of
    X^T's CSR, from its values, both trained toward T = X X^T: K6 forward,
    K9 twice backward, with the plain versions refused; steps
    1/(2 ||X||^2) and 1/(4 ||X||^2); then one more step with
    ``triangular`` toward triu(T) (the gram's launch, G's upper triangle
    in K9).  Returns the launches and the run's record."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    A, B = formats.to_device(x), formats.to_device(x.T.tocsr())
    a_ip, a_ix, a_dv = A.csr_arrays()
    b_ip, b_ix, b_dv = B.csr_arrays()
    n = x.shape[0]
    target = cuda((x @ x.T).toarray())
    norm_sq = host_norm_sq(x)

    b_sorted = B.csr_sorted()

    def fn(av, bv, triangular=False):
        return spgemm.csr_spgemm_dense(a_ip, a_ix, av, b_ip, b_ix, bv, n,
                                       triangular=triangular,
                                       b_sorted=b_sorted)

    def plain(av, bv, triangular=False):
        return spgemm.csr_spgemm_dense_plain(a_ip, a_ix, av, b_ip, b_ix, bv,
                                             n, triangular=triangular)

    run = GradRun("spgemm_dense_f64_a_and_b", fn, plain,
                  (torch.zeros_like(a_dv), b_dv),
                  (0.5 / norm_sq, 0.25 / norm_sq), target,
                  "CsrSpgemmDenseBackward")
    reset_launches()
    with plain_versions_refused():
        run.run(SPGEMM_STEPS)
        busy = profiled(run)
        t0 = time.perf_counter()
        tri_loss = run.step(keep=True, target=torch.triu(target),
                            triangular=True)
        tri_wall = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    expected = {name: 0 for name in launches}
    expected.update(K6_csr_spgemm_dense=SPGEMM_STEPS + 2,
                    K9_csr_spgemm_sddmm=2 * (SPGEMM_STEPS + 2))
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    record = run.check()
    if not np.isfinite(float(tri_loss)):
        raise AssertionError(f"triangular step: loss {float(tri_loss)}")
    return launches, {**record, **busy, "triangular_step_loss":
                      float(tri_loss), "triangular_step_wall_ms": tri_wall,
                      "lr": [0.5 / norm_sq, 0.25 / norm_sq]}


def spgemm_sparse_training(a_np, b_np=None):
    """SGD through ``csr_spgemm`` (sparse output) on op(A) = ``a_np`` and
    op(B) = ``b_np`` (f64; None: op(B) on op(A)'s one pattern, as case
    c's 1M^2 A @ A has it), two value tensors, op(A)'s from zero and
    op(B)'s from its values, both trained toward T = (A @ B)'s values on
    C's pattern, loss ||C.data - T||^2: K4 + K5 forward, K11 twice
    backward, with the plain versions refused; steps 1/(2 ||A||^2) and
    1/(4 ||A||^2) (``b_np`` is A^T or A: the same norm).  Returns the
    launches and the run's record."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    ip, ix, dv = formats.to_device(a_np).csr_arrays()
    bip, bix, bdv = ((ip, ix, dv) if b_np is None
                     else formats.to_device(b_np).csr_arrays())
    n = a_np.shape[1] if b_np is None else b_np.shape[1]
    target = spgemm.csr_spgemm(ip, ix, dv, bip, bix, bdv, n)[2]
    norm_sq = host_norm_sq(a_np)

    def fn(av, bv):
        return spgemm.csr_spgemm(ip, ix, av, bip, bix, bv, n)[2]

    def plain(av, bv):
        return spgemm.spgemm_plain(ip, ix, av, bip, bix, bv, n)[2]

    lrs = (0.5 / norm_sq, 0.25 / norm_sq)
    run = GradRun("spgemm_sparse_f64_a_and_b", fn, plain,
                  (torch.zeros_like(dv), bdv), lrs, target,
                  "CsrSpgemmBackward")
    reset_launches()
    with plain_versions_refused():
        run.run(SPGEMM_STEPS)
        busy = profiled(run)
    launches = read_launches()
    expected = {name: 0 for name in launches}
    expected.update(K4_csr_spgemm_count=SPGEMM_STEPS + 1,
                    K5_csr_spgemm_fill=SPGEMM_STEPS + 1,
                    K11_csr_spgemm_sparse_sddmm=2 * (SPGEMM_STEPS + 1))
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    per_step = {name: count / (SPGEMM_STEPS + 1)
                for name, count in launches.items() if count}
    return launches, {**run.check(), **busy, "lr": list(lrs),
                      "launches_per_step": per_step,
                      "c_nnz": int(target.numel())}


def spgemm_sparse_demo_training(x):
    """``spgemm_sparse_training`` at case a: the demo X @ X.T (X 500 x
    5000, 21.2%, f64), op(A) = X and op(B) = a CSR of X^T, where K11
    stages lines of G in both forms."""
    return spgemm_sparse_training(x, x.T.tocsr())


# Timed repeats of each phase-6 Hessian-vector product after its checked
# first call, and how far (relative to the largest |entry|) it may lie
# from torch's double backward through the plain versions: the two sum
# in different orders, in f64.
HVP_REPS = 5
HVP_RTOL = 1e-12


def hvp_run(fn, plain, params, expected, seed):
    """One Hessian-vector product of the non-quadratic loss
    sum(sin(fn(*params))) in every one of ``params`` (f64), by double
    backward along a random direction made from ``seed``, with the plain
    versions refused: its launches must be ``expected`` (every other
    kernel none), and it must lie within HVP_RTOL of max|plain| of
    torch's double backward through ``plain`` on the same tensors.
    Timed on the host clock, host to host (to a synchronize): the first
    call and the median of HVP_REPS more; the device's busy ms of one
    more in a ``torch.profiler`` trace.  Returns the launches (of the
    first call) and the record."""
    rng = np.random.default_rng(seed)
    u = [cuda(values(rng, tuple(p.shape), np.float64)) for p in params]

    def hvp(f):
        ps = [p.clone().requires_grad_() for p in params]
        grads = torch.autograd.grad(torch.sin(f(*ps)).sum(), ps,
                                    create_graph=True)
        dot = sum((g * w).sum() for g, w in zip(grads, u))
        out = torch.autograd.grad(dot, ps)
        torch.cuda.synchronize()
        return out

    def timed():
        t0 = time.perf_counter()
        out = hvp(fn)
        return out, (time.perf_counter() - t0) * 1e3

    reset_launches()
    with plain_versions_refused():
        got, first = timed()
        launches = read_launches()
        walls = [timed()[1] for _ in range(HVP_REPS)]
        busy = device_busy_ms(lambda: hvp(fn))
    want = {name: 0 for name in launches}
    want.update(expected)
    if launches != want:
        raise AssertionError(f"HVP launched {launches}, expected {want}")
    errs = []
    for g, r in zip(got, hvp(plain)):
        scale = float(r.abs().max())
        errs.append(float((g - r).abs().max()) / scale)
        if not (scale > 0 and np.isfinite(scale) and errs[-1] <= HVP_RTOL):
            raise AssertionError(f"HVP off the plain one by {errs[-1]} of "
                                 f"{scale}")
    wall = float(np.median(walls))
    return launches, {
        "max_rel_err_vs_plain": errs, "first_wall_ms": first,
        "wall_ms": wall, "wall_min_ms": min(walls),
        "wall_max_ms": max(walls), "device_busy_ms": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "launches": {k: v for k, v in launches.items() if v},
        "shapes": [list(p.shape) for p in params]}


def bsr_hvp(inputs):
    """``hvp_run`` through ``ops.bsr_spmm`` at config 3 (8192^2, bs 64, 5%
    of blocks, f64: K1 and K8 on the tensor cores) in its blocks and
    phase 3's b (8192 x 256).  One product: K1 forward; K8 and K1 over
    A^H in the first backward; in the second, K1 twice (``BsrSddmm``'s
    backward), K8 and K1 over A^H's transpose (``BsrSpmm`` over A^H) and
    K8 and K1 over A^H (``BsrSpmm`` over A): K1 6 times, K8 3."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, bsr

    a = inputs["bsrs"][(64, np.float64)]
    bs, (m, k) = a.blocksize[0], a.shape
    rows = np.repeat(np.arange(m // bs), np.diff(a.indptr))
    r3, c3 = cuda(rows.astype(np.int32)), cuda(a.indices.astype(np.int32))

    def plain(d, bb):
        p = autograd.bsr_structures.get(r3, c3, m, k, bs)
        return bsr.bsr_spmm_plain(p.indptr, p.indices, d[p.order], bb)

    return hvp_run(lambda d, bb: ops.bsr_spmm(d, r3, c3, bb, m), plain,
                   (cuda(a.data), cuda(inputs["b3"][np.float64])),
                   {"K1_bsr_spmm_tc": 6, "K8_bsr_sddmm_tc": 3}, SEED + 20)


def spgemm_dense_hvp(x):
    """``hvp_run`` through ``csr_spgemm_dense`` on the demo X @ X.T (X 500
    x 5000, 21.2%, f64; op(B) a CSR of X^T) in both operands' values.
    One product: K6 forward; K9 twice in the first backward; in the
    second, K6 and K9 for each of the first backward's K9 calls
    (``CsrSpgemmSddmm``'s backward) and K9 twice (``CsrSpgemmDense``'s):
    K6 3 times, K9 6."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    A, B = formats.to_device(x), formats.to_device(x.T.tocsr())
    a_ip, a_ix, a_dv = A.csr_arrays()
    b_ip, b_ix, b_dv = B.csr_arrays()
    n, b_sorted = x.shape[0], B.csr_sorted()
    return hvp_run(
        lambda av, bv: spgemm.csr_spgemm_dense(a_ip, a_ix, av, b_ip, b_ix,
                                               bv, n, b_sorted=b_sorted),
        lambda av, bv: spgemm.csr_spgemm_dense_plain(a_ip, a_ix, av, b_ip,
                                                     b_ix, bv, n),
        (a_dv, b_dv), {"K6_csr_spgemm_dense": 3, "K9_csr_spgemm_sddmm": 6},
        SEED + 21)


def spgemm_sparse_hvp(a_np):
    """``hvp_run`` through ``csr_spgemm`` on case c's 1M^2 A @ A (f64),
    two value tensors on A's one pattern, in both.  One product: K4 and
    K5 forward; K11 twice in the first backward; in the second, K5 on C's
    saved pattern and K11 for each of the first backward's K11 calls
    (``CsrSpgemmSparseSddmm``'s backward) and K11 twice (``CsrSpgemm``'s):
    K4 once, K5 3 times, K11 6."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    ip, ix, dv = formats.to_device(a_np).csr_arrays()
    n = a_np.shape[1]
    return hvp_run(
        lambda av, bv: spgemm.csr_spgemm(ip, ix, av, ip, ix, bv, n)[2],
        lambda av, bv: spgemm.spgemm_plain(ip, ix, av, ip, ix, bv, n)[2],
        (dv, dv.clone()), {"K4_csr_spgemm_count": 1,
                           "K5_csr_spgemm_fill": 3,
                           "K11_csr_spgemm_sparse_sddmm": 6}, SEED + 22)


def hessian_vector_product(inputs):
    """``hvp_run`` through ``ops.coo_spmm_raw`` on BASELINE config 1's
    pattern and values and phase 3's b (f64), in (values, b), against
    ``csr_spmm_plain``.  One product: K2 forward; K7 and K2 over A^H in
    the first backward; in the second, K2 twice (``CsrSddmm``'s
    backward), K7 and K2 over A^H's transpose, and K7 and K2 over A^H: K2
    6 times, K7 3."""
    from sparse_dot_tpu_torch.ops import autograd, csr

    r1, c1, m1, b1, _, _ = config1_problem(inputs)
    s = autograd.structures.get(r1, c1, m1, b1.shape[0])
    return hvp_run(
        lambda v, b: autograd.coo_spmm_raw(r1, c1, v, b, m1),
        lambda v, b: csr.csr_spmm_plain(s.pattern.indptr, s.pattern.indices,
                                        v[s.order], b),
        (cuda(inputs["a1"].data), b1), {"K2_csr_spmm": 6, "K7_csr_sddmm": 3},
        SEED + 19)


# Phase 6's batched runs: members of the per-sample gradients (config 1)
# and of the ensemble (config 3), the small pattern of jacrev and hessian
# ((m, k, mean row, n)), and the timed repeats after each first call.
PER_SAMPLE, ENSEMBLE = 16, 4
JAC_PATTERN = (300, 200, 5, 4)
BATCHED_REPS = 5


def launches_delta(before):
    """``read_launches()`` less ``before``, the kernels that moved."""
    now = read_launches()
    return {name: now[name] - before[name] for name in now
            if now[name] != before[name]}


def batched_run(name, fn, expected, expected_batched, member_loop=None):
    """One batched run on the card, the plain versions refused: fn()'s
    first call must make exactly ``expected`` launches (every other
    kernel none), ``expected_batched`` of them batched (``read_batched``);
    then BATCHED_REPS more calls timed host to host (to a synchronize),
    taken in turns with ``member_loop`` (the same work one member at a
    time) when given, and the device's busy ms of one more call of each
    (``device_busy_ms``); the first result against the member loop's
    (single launches).  Returns (fn()'s first result, the record)."""
    def timed(f):
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with plain_versions_refused():
        before, before_b = read_launches(), read_batched()
        out, first = timed(fn)
        got = launches_delta(before)
        now_b = read_batched()
        got_b = {k: now_b[k] - before_b[k] for k in now_b
                 if now_b[k] != before_b[k]}
        if got != expected or got_b != expected_batched:
            raise AssertionError(f"{name}: launched {got} ({got_b} "
                                 f"batched), expected {expected} "
                                 f"({expected_batched} batched)")
        loop_diff = None
        if member_loop is not None:
            looped = [tensor_leaves(r) for r in member_loop()]
            torch.cuda.synchronize()
            loop_diff = max(
                float((got - torch.stack([r[j] for r in looped])).abs().max())
                for j, got in enumerate(tensor_leaves(out)))
            del looped
        walls, loop_walls = [], []
        for _ in range(BATCHED_REPS):
            walls.append(timed(fn)[1])
            if member_loop is not None:
                loop_walls.append(timed(member_loop)[1])
        busy = device_busy_ms(fn)
        loop_busy = (device_busy_ms(member_loop) if member_loop is not None
                     else None)
    wall = float(np.median(walls))
    record = {"launches": got, "launches_batched": got_b,
              "first_wall_ms": first, "wall_ms": wall,
              "wall_min_ms": min(walls), "wall_max_ms": max(walls),
              "device_busy_ms": busy,
              "device_idle_share": None if busy is None else 1 - busy / wall}
    if member_loop is not None:
        loop_wall = float(np.median(loop_walls))
        record.update(member_loop_wall_ms=loop_wall,
                      member_loop_device_busy_ms=loop_busy,
                      wall_over_member_loop=wall / loop_wall,
                      max_abs_diff_vs_member_loop=loop_diff)
    return out, record


def complex_bsr_vmap(inputs, runs, errs):
    """Per-sample gradients at phase 3's complex BSR (4000^2, bs 16, 5% of
    blocks, c128): ``vmap`` over ENSEMBLE b's (from SEED + 34) of ``grad``
    of ||A b_i - t||^2 in (blocks, b_i), the blocks shared: K1 on the
    tensor cores' complex instances twice (the members folded into its
    columns, forward and over A^H), K8 once, batched; the member loop
    beside it; each member's gradient in the blocks against
    ``bsr_sddmm_plain`` of the plain residual.  Adds its record to
    ``runs`` and its error to ``errs``."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, bsr

    rng = np.random.default_rng(SEED + 34)
    a = inputs["abc"]
    bs, (m, k) = a.blocksize[0], a.shape
    r = cuda(np.repeat(np.arange(m // bs), np.diff(a.indptr))
             .astype(np.int32))
    c = cuda(a.indices.astype(np.int32))
    d = cuda(a.data)
    bb = cuda(values(rng, (ENSEMBLE, k, 64), np.complex128))
    t = cuda(values(rng, (m, 64), np.complex128))

    def loss(dd, b):
        return squares(ops.bsr_spmm(dd, r, c, b, m) - t)

    grad = torch.func.grad(loss, argnums=(0, 1))
    name = "per_sample_grads_complex_bsr_c128"
    grads, runs[name] = batched_run(
        "complex per-sample gradients",
        lambda: torch.func.vmap(grad, in_dims=(None, 0))(d, bb),
        {"K1_bsr_spmm_tc_complex": 2, "K8_bsr_sddmm_tc_complex": 1},
        {"K8_bsr_sddmm_tc_complex": 1},
        lambda: [grad(d, bb[i]) for i in range(ENSEMBLE)])
    p = autograd.bsr_structures.get(r, c, m, k, bs)
    err = 0.0
    for i in range(ENSEMBLE):
        g = 2 * (bsr.bsr_spmm_plain(p.indptr, p.indices, d[p.order], bb[i])
                 - t)
        ref = bsr.bsr_sddmm_plain(p.indptr, p.indices, g, bb[i], bs)
        err = max(err, compare(grads[0][i][p.order], ref, ref.dtype))
    errs[name] = err


def batched_training(inputs, spgemm_inp):
    """Phase 6's batched runs, each a first call with its exact launches
    (one a ``vmap`` level, the plain versions refused), timed wall and
    device busy ms, and its result against the plain versions:

    - per-sample gradients at config 1 (f64): ``vmap`` of ``grad`` of
      each member's ||A b_i - t_i||^2 in A's values (shared) over
      PER_SAMPLE pairs (b_i, t_i) of (10,000, 128): K2 once (the members
      folded into its columns), K7 once (batched); beside it, in the same
      turns, the same gradients one member at a time (``torch.func.grad``
      a member: PER_SAMPLE K2 and K7 launches); each member's gradient
      against the plain versions (``csr_sddmm_plain`` of the plain
      residual);
    - an ensemble at config 1 (f64): ``vmap`` over ENSEMBLE value sets of
      A of ``grad`` of ||A_i b - t||^2, b shared: K2 once (batched, a
      group of members a block, which one more call checks by
      ``csr_spmm.launches_group``) and K7 once (batched, B shared); the
      member loop beside it; against the plain versions;
    - an ensemble at config 3 (bs 64, f64): ``vmap`` over ENSEMBLE block
      sets of ``grad`` of ||A_i b - t||^2 in the blocks: K1 once and K8
      once, both batched, on the tensor cores; the member loop beside
      it; against ``bsr_sddmm_plain``;
    - per-sample gradients at the complex BSR (``complex_bsr_vmap``): K1
      twice, K8 once (batched), on the tensor cores' complex instances;
    - ``jacrev`` of ``coo_spmm_raw`` in the values at a small pattern
      (JAC_PATTERN, f64): K2 once, K7 once (batched over the m * n
      cotangents);
    - ``hessian`` of sum(sin(``coo_spmm_raw``)) in (values, b) there: K2
      6 times (2 batched), K7 3 times (batched);

    the last two against the same transform on CPU copies of the inputs,
    where the Functions run the plain versions; then the sparse x sparse
    runs (``batched_spgemm_training``).  Returns the launches of all (the
    ``vmap`` path)."""
    from sparse_dot_tpu_torch import ops
    from sparse_dot_tpu_torch.ops import autograd, bsr, csr, sddmm, spgemm

    rng = np.random.default_rng(SEED + 23)
    reset_launches()
    runs, errs = {}, {}
    # Per-sample gradients at config 1.
    r1, c1, m1, b1, t1, _ = config1_problem(inputs)
    s = autograd.structures.get(r1, c1, m1, b1.shape[0])
    v = cuda(inputs["a1"].data * 0.5)
    bs = b1 + 0.1 * cuda(values(rng, (PER_SAMPLE, *b1.shape), np.float64))
    ts = t1 + 0.1 * cuda(values(rng, (PER_SAMPLE, *t1.shape), np.float64))

    def loss(vv, b, t):
        return ((autograd.coo_spmm_raw(r1, c1, vv, b, m1) - t) ** 2).sum()

    grads, runs["per_sample_grads_config1_f64"] = batched_run(
        "per-sample gradients",
        lambda: torch.func.vmap(torch.func.grad(loss),
                                in_dims=(None, 0, 0))(v, bs, ts),
        {"K2_csr_spmm": 1, "K7_csr_sddmm": 1}, {"K7_csr_sddmm": 1},
        lambda: [torch.func.grad(loss)(v, bs[i], ts[i])
                 for i in range(PER_SAMPLE)])
    ip, ix, order = s.pattern.indptr, s.pattern.indices, s.order
    err = 0.0
    for i in range(PER_SAMPLE):
        g = 2 * (csr.csr_spmm_plain(ip, ix, v[order], bs[i]) - ts[i])
        ref = sddmm.csr_sddmm_plain(ip, ix, g, bs[i])
        err = max(err, compare(grads[i][order], ref, ref.dtype))
    errs["per_sample_grads_config1_f64"] = err
    del bs, ts, grads
    # An ensemble at config 1: ENSEMBLE value sets of A, b shared.
    vs = v[None] * (1 + 0.1 * cuda(values(rng, (ENSEMBLE, v.numel()),
                                          np.float64)))

    def ensemble_loss(vv):
        return ((autograd.coo_spmm_raw(r1, c1, vv, b1, m1) - t1) ** 2).sum()

    name = "ensemble_grads_config1_f64"
    grads, runs[name] = batched_run(
        "config-1 ensemble gradients",
        lambda: torch.func.vmap(torch.func.grad(ensemble_loss))(vs),
        {"K2_csr_spmm": 1, "K7_csr_sddmm": 1},
        {"K2_csr_spmm": 1, "K7_csr_sddmm": 1},
        lambda: [torch.func.grad(ensemble_loss)(vs[i])
                 for i in range(ENSEMBLE)])
    before = csr.csr_spmm.launches_group
    torch.func.vmap(torch.func.grad(ensemble_loss))(vs)
    runs[name]["k2_group_launches_a_call"] = (csr.csr_spmm.launches_group
                                              - before)
    if runs[name]["k2_group_launches_a_call"] != 1:
        raise AssertionError(f"{name}: K2 did not run its member groups")
    n1 = b1.shape[1]
    runs[name]["members_a_group"] = {
        "K2": csr.batched_plan(n1, b1.dtype, ix.numel() / m1, True,
                               ix.element_size(), ENSEMBLE, True, True)[1],
        "K7": sddmm.batched_schedule(n1, b1.dtype, ix.numel(), ENSEMBLE,
                                     (m1 * n1, 0), True,
                                     ix.element_size())[1]}
    err = 0.0
    for i in range(ENSEMBLE):
        g = 2 * (csr.csr_spmm_plain(ip, ix, vs[i][order], b1) - t1)
        ref = sddmm.csr_sddmm_plain(ip, ix, g, b1)
        err = max(err, compare(grads[i][order], ref, ref.dtype))
    errs[name] = err
    del vs, grads
    # An ensemble at config 3.
    a3 = inputs["bsrs"][(64, np.float64)]
    m3, k3 = a3.shape
    r3 = cuda(np.repeat(np.arange(m3 // 64), np.diff(a3.indptr))
              .astype(np.int32))
    c3 = cuda(a3.indices.astype(np.int32))
    b3 = cuda(inputs["b3"][np.float64])
    t3 = cuda(a3 @ inputs["b3"][np.float64])
    blocks_ = cuda(a3.data)[None] * (
        1 + 0.1 * cuda(values(rng, (ENSEMBLE, *a3.data.shape), np.float64)))

    def bsr_loss(d):
        return ((ops.bsr_spmm(d, r3, c3, b3, m3) - t3) ** 2).sum()

    grads, runs["ensemble_grads_config3_f64"] = batched_run(
        "ensemble gradients", lambda: torch.func.vmap(
            torch.func.grad(bsr_loss))(blocks_),
        {"K1_bsr_spmm_tc": 1, "K8_bsr_sddmm_tc": 1},
        {"K1_bsr_spmm_tc": 1, "K8_bsr_sddmm_tc": 1},
        lambda: [torch.func.grad(bsr_loss)(blocks_[i])
                 for i in range(ENSEMBLE)])
    p = autograd.bsr_structures.get(r3, c3, m3, k3, 64)
    err = 0.0
    for i in range(ENSEMBLE):
        g = 2 * (bsr.bsr_spmm_plain(p.indptr, p.indices,
                                    blocks_[i][p.order], b3) - t3)
        ref = bsr.bsr_sddmm_plain(p.indptr, p.indices, g, b3, 64)
        err = max(err, compare(grads[i][p.order], ref, ref.dtype))
    errs["ensemble_grads_config3_f64"] = err
    del blocks_, grads
    complex_bsr_vmap(inputs, runs, errs)
    # jacrev and hessian at a small pattern, against CPU copies.
    m, k, mean_row, n = JAC_PATTERN
    indptr, indices, data = random_csr(rng, m, k, mean_row, np.float64)
    rows = np.repeat(np.arange(m), np.diff(indptr)).astype(np.int32)
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (rows, indices, data, values(rng, (k, n), np.float64))]
    card = [t.cuda() for t in host]

    def jac(r, c, vv, b):
        return torch.func.jacrev(
            lambda x: autograd.coo_spmm_raw(r, c, x, b, m))(vv)

    def hess(r, c, vv, b):
        return torch.func.hessian(
            lambda x, y: torch.sin(autograd.coo_spmm_raw(r, c, x, y,
                                                         m)).sum(),
            argnums=(0, 1))(vv, b)

    for name, fn, expected, batched in (
            ("jacrev_values_small_f64", jac,
             {"K2_csr_spmm": 1, "K7_csr_sddmm": 1}, {"K7_csr_sddmm": 1}),
            ("hessian_values_and_b_small_f64", hess,
             {"K2_csr_spmm": 6, "K7_csr_sddmm": 3},
             {"K2_csr_spmm": 2, "K7_csr_sddmm": 3})):
        out, runs[name] = batched_run(name, lambda: fn(*card), expected,
                                      batched)
        ref = fn(*host)
        leaves = [t.cpu() for t in tensor_leaves(out)]
        err = 0.0
        for got, want in zip(leaves, tensor_leaves(ref)):
            err = max(err, compare(got, want, want.dtype))
        errs[name] = err
        runs[name]["members"] = (m * n if name.startswith("jacrev")
                                 else len(indices) + k * n)
    batched_spgemm_training(runs, errs, spgemm_inp, rng)
    for name, record in runs.items():
        record["max_abs_err_vs_plain"] = errs[name]
    launches = read_launches()
    emit("6-vmap", launches=launches, batched_launches=read_batched(),
         group_launches={
             "K1_bsr_spmm_tc": bsr.bsr_spmm.launches_group,
             "K2_csr_spmm": csr.csr_spmm.launches_group,
             "K5_csr_spgemm_fill": spgemm.csr_spgemm_fill.launches_group,
             "K6_csr_spgemm_dense": spgemm.csr_spgemm_dense.launches_group},
         runs=runs, members={"per_sample": PER_SAMPLE,
                             "ensemble": ENSEMBLE},
         jac_pattern=dict(zip(("m", "k", "mean_row", "n"), JAC_PATTERN)),
         timer=f"host clock, host to host to a synchronize, first call and "
               f"median of {BATCHED_REPS} more, the member loop in the "
               "same turns; device busy: torch.profiler, one more call")
    return launches


# Phase 6's small sparse x sparse pattern for jacrev and hessian: op(A)
# (m x k) and op(B) (k x n) with (op(A)'s, op(B)'s) row lengths.
SPGEMM_JAC_PATTERN = (60, 50, 40, (4, 3, 5), (5, 2, 6))


def batched_spgemm_training(runs, errs, inp, rng):
    """Phase 6's batched sparse x sparse runs (``batched_run``: exact
    launches, the plain versions refused), into ``runs`` and ``errs``:

    - an ensemble over ENSEMBLE value sets of the demo X as op(A) (op(B)
      a CSR of X^T, its values shared) through ``csr_spgemm_dense``:
      ``vmap`` of ``grad`` of ||op(A)_i op(B) - T||^2 in (op(A)'s, op(B)'s
      values): K6 once, K9 twice, all batched; the member loop beside it;
      each member's gradients against the plain versions on the card
      (``csr_spgemm_dense_plain``, ``sampled_rows_plain``,
      ``sampled_cols_plain``);
    - ``jacrev`` of ``csr_spgemm_dense`` in op(A)'s values at
      SPGEMM_JAC_PATTERN: K6 once, K9 once (batched over the m n
      cotangents);
    - ``hessian`` of sum(sin(``csr_spgemm``'s values)) in (op(A)'s,
      op(B)'s values) there: K4 1, K5 3 (2 batched), K11 6 (batched);
      both against the same transform on CPU copies;
    - an ensemble over ENSEMBLE value sets of op(A) of the 1M^2 A @ A with
      sparse output: ``vmap`` of ``grad`` of ||C_i - T||^2 on C's
      pattern in (op(A)'s, op(B)'s values): one K4, one K5 and K11 twice,
      K5 and K11 batched; the member loop beside it; against
      ``spgemm_plain`` and ``csr_spgemm_sparse_sddmm_plain`` on the
      card."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm, spgemm_grad

    # The demo X @ X.T ensemble (dense output).
    x = inp["x"]
    A, B = formats.to_device(x), formats.to_device(x.T.tocsr())
    ip, ix, dv = A.csr_arrays()
    bip, bix, bdv = B.csr_arrays()
    n = x.shape[0]
    target = cuda((x @ x.T).toarray())
    avs = dv[None] * (1 + 0.1 * cuda(values(rng, (ENSEMBLE, ix.numel()),
                                            np.float64)))

    def dense_loss(av, bv):
        c = spgemm.csr_spgemm_dense(ip, ix, av, bip, bix, bv, n)
        return ((c - target) ** 2).sum()

    grad = torch.func.grad(dense_loss, argnums=(0, 1))
    name = "ensemble_grads_spgemm_dense_demo_f64"
    grads, runs[name] = batched_run(
        name, lambda: torch.func.vmap(grad, in_dims=(0, None))(avs, bdv),
        {"K6_csr_spgemm_dense": 1, "K9_csr_spgemm_sddmm": 2},
        {"K6_csr_spgemm_dense": 1, "K9_csr_spgemm_sddmm": 2},
        lambda: [grad(avs[i], bdv) for i in range(ENSEMBLE)])
    t, order = formats.CsrPattern(ip, ix, x.shape[1]).transpose()
    err = 0.0
    for i in range(ENSEMBLE):
        g = 2 * (spgemm.csr_spgemm_dense_plain(ip, ix, avs[i], bip, bix, bdv,
                                               n) - target)
        refs = (spgemm_grad.sampled_rows_plain(ip, ix, g, bip, bix, bdv),
                spgemm_grad.sampled_cols_plain(bip, bix, g, t.indptr,
                                               t.indices, avs[i][order]))
        for got, ref in zip(grads, refs):
            err = max(err, compare(got[i], ref, ref.dtype))
    errs[name] = err
    del A, B, avs, grads, target
    # jacrev and hessian at a small pattern, against CPU copies.
    m, k, nn, a_rows, b_rows = SPGEMM_JAC_PATTERN
    host = [torch.from_numpy(arr) for arr in (
        *distinct_rows(rng, np.resize(a_rows, m), k, np.float64, np.int32),
        *distinct_rows(rng, np.resize(b_rows, k), nn, np.float64,
                       np.int32))]
    card = [arr.cuda() for arr in host]

    def jac(a_ip, a_ix, av, b_ip, b_ix, bv):
        return torch.func.jacrev(lambda z: spgemm.csr_spgemm_dense(
            a_ip, a_ix, z, b_ip, b_ix, bv, nn))(av)

    def hess(a_ip, a_ix, av, b_ip, b_ix, bv):
        return torch.func.hessian(lambda y, z: torch.sin(spgemm.csr_spgemm(
            a_ip, a_ix, y, b_ip, b_ix, z, nn)[2]).sum(),
            argnums=(0, 1))(av, bv)

    for name, fn, expected, batched, members in (
            ("jacrev_spgemm_dense_small_f64", jac,
             {"K6_csr_spgemm_dense": 1, "K9_csr_spgemm_sddmm": 1},
             {"K9_csr_spgemm_sddmm": 1}, m * nn),
            ("hessian_spgemm_sparse_small_f64", hess,
             {"K4_csr_spgemm_count": 1, "K5_csr_spgemm_fill": 3,
              "K11_csr_spgemm_sparse_sddmm": 6},
             {"K5_csr_spgemm_fill": 2, "K11_csr_spgemm_sparse_sddmm": 6},
             host[1].numel() + host[4].numel())):
        out, runs[name] = batched_run(name, lambda: fn(*card), expected,
                                      batched)
        err = 0.0
        for got, want in zip(tensor_leaves(out), tensor_leaves(fn(*host))):
            err = max(err, compare(got.cpu(), want, want.dtype))
        errs[name] = err
        runs[name]["members"] = members
    # The 1M^2 A @ A ensemble (sparse output).
    A = formats.to_device(inp["a1m"])
    ip, ix, dv = A.csr_arrays()
    n = inp["a1m"].shape[1]
    c_ip, c_ix, c_dv = spgemm.csr_spgemm(ip, ix, dv, ip, ix, dv, n)
    target = c_dv * (1 + 0.1 * cuda(values(rng, c_dv.numel(), np.float64)))
    avs = dv[None] * (1 + 0.1 * cuda(values(rng, (ENSEMBLE, ix.numel()),
                                            np.float64)))

    def sparse_loss(av, bv):
        return ((spgemm.csr_spgemm(ip, ix, av, ip, ix, bv, n)[2] - target)
                ** 2).sum()

    grad = torch.func.grad(sparse_loss, argnums=(0, 1))
    name = "ensemble_grads_spgemm_sparse_1m_f64"
    grads, runs[name] = batched_run(
        name, lambda: torch.func.vmap(grad, in_dims=(0, None))(avs, dv),
        {"K4_csr_spgemm_count": 1, "K5_csr_spgemm_fill": 1,
         "K11_csr_spgemm_sparse_sddmm": 2},
        {"K5_csr_spgemm_fill": 1, "K11_csr_spgemm_sparse_sddmm": 2},
        lambda: [grad(avs[i], dv) for i in range(ENSEMBLE)])
    err = 0.0
    for i in range(ENSEMBLE):
        g = 2 * (spgemm.spgemm_plain(ip, ix, avs[i], ip, ix, dv, n)[2]
                 - target)
        for got, transposed in zip(grads, (False, True)):
            ref = spgemm_grad.csr_spgemm_sparse_sddmm_plain(
                ip, ix, avs[i], ip, ix, dv, c_ip, c_ix, g, n, transposed)
            err = max(err, compare(got[i], ref, ref.dtype))
    errs[name] = err
    del A, avs, grads, target, c_dv
    torch.cuda.empty_cache()


def tensor_leaves(x):
    """The tensors of a nested tuple of tensors, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in tensor_leaves(item)]


def grad_training(inputs, spgemm_inp, which=("K8", "K9", "K11")):
    """Phase 6's runs of K8 (``bsr_training``, then ``bsr_hvp``), K9
    (``spgemm_training``, then ``spgemm_dense_hvp``) and K11
    (``spgemm_sparse_training`` at case c and at case a, then
    ``spgemm_sparse_hvp`` and ``hessian_vector_product``, the second
    order of the CSR device API), each with the counts set to 0 just
    before it: one JSON line, and the launches of all summed."""
    runs, launches = {}, {name: 0 for name in KERNELS}
    for kernel, name, train, arg in (
            ("K8", "bsr_f64_blocks_and_b", bsr_training, inputs),
            ("K8", "hvp_bsr_spmm_config3_f64", bsr_hvp, inputs),
            ("K9", "spgemm_dense_f64_a_and_b", spgemm_training,
             spgemm_inp["x"]),
            ("K9", "hvp_csr_spgemm_dense_demo_f64", spgemm_dense_hvp,
             spgemm_inp["x"]),
            ("K11", "spgemm_sparse_f64_a_and_b", spgemm_sparse_training,
             spgemm_inp["a1m"]),
            ("K11", "spgemm_sparse_demo_f64_a_and_b",
             spgemm_sparse_demo_training, spgemm_inp["x"]),
            ("K11", "hvp_csr_spgemm_1m_f64", spgemm_sparse_hvp,
             spgemm_inp["a1m"]),
            ("K11", "hvp_coo_spmm_raw_config1_f64", hessian_vector_product,
             inputs)):
        if kernel in which:
            got, runs[name] = train(arg)
            launches = {key: launches[key] + got[key] for key in launches}
    emit("6-grad", launches=launches, runs=runs,
         timer="host clock per step to a synchronize, median of steps "
               "2..N; HVPs: host clock, host to host, first call and "
               f"median of {HVP_REPS} more; device busy: torch.profiler, "
               "one more step or HVP")
    return launches


# Each solve's matrix in phase 4: the K3 (K2) rows whose times make one
# step's matvecs (CGLS: A and A^T).
SOLVE_MATVECS = {
    "cg": ("1M Laplacian, 5.0 M nnz",),
    "cg_symmetric_triangle": ("1M Laplacian, 5.0 M nnz",),
    "pardiso_krylov_1M_spd": ("1M Laplacian, 5.0 M nnz",),
    "fgmres_20": ("1M convection-diffusion",),
    "cg_mrhs_16": ("1M Laplacian, 5.0 M nnz @ (1000000, 16)",),
    "qr_cgls_1.2Mx50k": ("CGLS A 1.2Mx50k @ (50k,)",
                         "CGLS A^T 50kx1.2M @ (1.2M,)"),
    "qr_cgls_1.2Mx50k_4rhs": ("CGLS A 1.2Mx50k @ (50k, 4)",
                              "CGLS A^T 50kx1.2M @ (1.2M, 4)"),
}


def solver_timings(records, rows):
    """Each solve's ms per iteration beside its matvecs' kernel time from
    phase 4 (the same matrices, the same timer)."""
    ms = {row["shape"]: row["ms"] for row in rows}
    for name, shapes in SOLVE_MATVECS.items():
        records[name]["matvec_ms"] = sum(ms[shape] for shape in shapes)
        records[name]["matvec_shapes"] = list(shapes)
    for rec in records.values():
        if "iterations" in rec:
            rec["ms_per_iteration"] = rec["wall_ms"] / rec["iterations"]
        if "matvecs" in rec:
            rec["ms_per_matvec"] = rec["wall_ms"] / rec["matvecs"]
    emit("5-times", solves=records,
         timer="matvec: phase 4's kernel times; solves: host clock, host in "
               f"to host out, median (min, max) of {SOLVE_REPS} after a "
               "first call; device busy: torch.profiler, one more solve; "
               "idle share: 1 - busy / median wall")


# ---------------------------------------------------------------------------
# Phase 7: the sharded layer (sparse_dot_tpu_torch.parallel) on one card
# ---------------------------------------------------------------------------

# Timed repeats of each phase-7 call after its checked first call.
SHARDED_REPS = 5


def host(x):
    """A result as numpy: a tensor on the card is copied to the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def sharded_inputs(inputs, solver_inp):
    """Phase 7's operands, from the earlier phases': config 1 (f64, and
    f32 and c128 copies), the 1M Laplacian and its right-hand side, the
    demo X, and config 5's 1.2M x 50k least-squares problem."""
    a1, b1 = inputs["a1"], inputs["b1"]
    return {
        "a1": a1, "b1": b1, "a1_f32": a1.astype(np.float32),
        "b1_f32": b1.astype(np.float32),
        "a1_c128": (a1 * (1 + 0.5j)).tocsr(), "b1_c128": b1 * (1 - 0.25j),
        "out1": values(np.random.default_rng(SEED + 7), b1.shape,
                       np.float64),
        "lap": solver_inp["lap"], "b": solver_inp["b"], "x": demo_x(),
        "cgls_a": solver_inp["cgls_a"], "cgls_b": solver_inp["cgls_b"],
        "cgls_b4": solver_inp["cgls_b4"],
    }


def array_err(name, got, want, decimal):
    """max |got - want|; raises past ``decimal`` or on a wrong shape or a
    non-finite value."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} or non-finite")
    np.testing.assert_array_almost_equal(got, want, decimal=decimal)
    return float(np.abs(got - want).max())


def sparse_err(name, got, want, decimal):
    """As ``array_err`` on the values, after the patterns (columns sorted
    in each row, explicit zeros kept) are found equal."""
    want = want.tocsr()
    want.sort_indices()
    if not (np.array_equal(got.indptr, want.indptr)
            and np.array_equal(got.indices, want.indices)):
        raise AssertionError(f"{name}: pattern differs")
    return array_err(name, got.data, want.data, decimal)


def collective_times(mesh, n_gather, n_reduce, reps=200):
    """Per call, the host ms (a loop of ``reps`` calls to a synchronize)
    and the device ms (CUDA events around the loop) of the collectives a
    sharded CG / CGLS step makes across ranks, called on NCCL itself
    (``parallel.comm`` skips them in a group of one): an all-gather of an
    f64 vector of ``n_gather`` (the 1M Laplacian's rows), an all-reduce of
    ``n_reduce`` (config 5's columns), and a copy of the same vector
    beside them."""
    import torch.distributed as dist

    group = mesh.get_group("rows")
    y = torch.randn(n_gather, dtype=torch.float64, device="cuda")
    z = torch.randn(n_reduce, dtype=torch.float64, device="cuda")
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    out = {}
    for name, fn in (("all_gather",
                      lambda: dist.all_gather(parts, y, group=group)),
                     ("all_reduce", lambda: dist.all_reduce(z, group=group)),
                     ("copy", lambda: y.clone())):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"host_ms": (time.perf_counter() - t0) * 1e3 / reps,
                     "device_ms": start.elapsed_time(end) / reps}
    return out


def sharded_path(inp):
    """Phase 7: each of the nine sharded ops and both routes
    (``dot_product`` and ``sparse_qr_solve`` on a ShardedCSR) in a
    one-rank NCCL group on the card at full width, the plain versions made
    to raise.  Each result is held against the single-device port's (the
    same kernels, its operand already on the card) and scipy's at decimal
    6 (f64, c128) or 5 (f32), or by the residuals phase 5 uses where scipy
    has no solve at this size.  Each op's line carries its wall ms host to
    host (first call apart, median of SHARDED_REPS after it), the
    single-device port's in the same turns, the device's busy ms of one
    more call and one call's launches.  Returns the launches of the
    sharded calls (the single-device calls not counted)."""
    import torch.distributed as dist

    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch import parallel

    card = card_line()
    mesh = parallel.make_mesh()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"phase 7 runs on {dist.get_backend()} x "
                             f"{dist.get_world_size()}, not one NCCL rank")
    totals = {name: 0 for name in KERNELS}

    def counted(fn):
        before = read_launches()
        out = fn()
        torch.cuda.synchronize()
        after = read_launches()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        for k, v in moved.items():
            totals[k] += v
        return out, moved

    def run(name, shape, sharded, single, check, expect):
        """One op's line; ``check(got, mine)`` returns its errors."""
        t0 = time.perf_counter()
        got, launched = counted(sharded)
        first = (time.perf_counter() - t0) * 1e3
        if set(launched) != set(expect):
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"{expect}")
        t0 = time.perf_counter()
        mine = single()
        single_first = (time.perf_counter() - t0) * 1e3
        errs = check(got, mine)
        walls = {"sharded": [], "single": []}
        for _ in range(SHARDED_REPS):
            for key, fn in (("sharded", lambda: counted(sharded)),
                            ("single", single)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[key].append((time.perf_counter() - t0) * 1e3)
        busy = device_busy_ms(lambda: counted(sharded))
        emit(7, op=name, shape=shape, card=card,
             wall_ms=float(np.median(walls["sharded"])),
             wall_min_ms=min(walls["sharded"]),
             wall_max_ms=max(walls["sharded"]), first_wall_ms=first,
             device_busy_ms=busy,
             single_wall_ms=float(np.median(walls["single"])),
             single_first_wall_ms=single_first, launches=launched, **errs)
        return got

    def both(name, ref, decimal, err=array_err, view=host):
        """The check of a result against the single-device port's and
        scipy's ``ref``."""
        return lambda got, mine: {
            "max_abs_err_vs_single": err(f"{name} vs single", view(got),
                                         host(mine), decimal),
            "max_abs_err_vs_scipy": err(f"{name} vs scipy", view(got), ref,
                                        decimal)}

    a1, b1, lap, x, xv = inp["a1"], inp["b1"], inp["lap"], inp["x"], inp["b"]
    cgls_a = inp["cgls_a"]
    dev = {key: sdt.to_device(inp[key]) for key in
           ("a1", "a1_f32", "a1_c128", "lap", "x", "cgls_a")}
    dev["xT"] = sdt.to_device(x.T.tocsr())
    shape1 = "config 1: 10k^2 1% @ (10k, 128)"
    reset_launches()
    with plain_versions_refused():
        rows = {dt: parallel.shard_csr_rows(inp[f"a1_{dt}"] if dt != "f64"
                                            else a1, 1, mesh)
                for dt in ("f64", "f32", "c128")}
        for dt, dec in (("f64", 6), ("f32", 5), ("c128", 6)):
            key = "" if dt == "f64" else f"_{dt}"
            a, b = inp["a1" + key], inp["b1" + key]
            run(f"sharded_spmm_{dt}", shape1,
                lambda a_sh=rows[dt], b=b: parallel.sharded_spmm(
                    mesh, a_sh, b).cpu(),
                lambda key=key, b=b: sdt.dot_product(dev["a1" + key], b),
                both(f"sharded_spmm_{dt}", a @ b, dec), ("K2_csr_spmm",))
        cols = parallel.shard_csr_cols(a1, 1, mesh, axis="cols")
        run("sharded_spmm_2d", shape1,
            lambda: parallel.sharded_spmm_2d(mesh, cols, b1).cpu(),
            lambda: sdt.dot_product(dev["a1"], b1),
            both("sharded_spmm_2d", a1 @ b1, 6), ("K2_csr_spmm",))
        grid = parallel.shard_csr_grid(a1, 1, mesh)
        run("sharded_spmm_ring", shape1,
            lambda: parallel.sharded_spmm_ring(mesh, grid, b1).cpu(),
            lambda: sdt.dot_product(dev["a1"], b1),
            both("sharded_spmm_ring", a1 @ b1, 6), ("K2_csr_spmm",))
        out = inp["out1"].copy()
        ref_out = a1 @ b1 + 2.0 * out

        def out_check(got, mine):
            if got is not out:
                raise AssertionError("dot_product(ShardedCSR, out=...) did "
                                     "not return out")
            return both("dot_product_out", ref_out, 6)(got.copy(), mine)

        run("dot_product_sharded_out", shape1 + ", out_scalar 2",
            lambda: sdt.dot_product(rows["f64"], b1, out=out,
                                    out_scalar=2.0),
            lambda: sdt.dot_product(dev["a1"], b1, out=inp["out1"].copy(),
                                    out_scalar=2.0),
            out_check, ("K2_csr_spmm",))
        lap_rows = parallel.shard_csr_rows(lap, 1, mesh)
        shape_lap = "1M Laplacian, 5.0 M nnz"
        run("sharded_spmv", shape_lap,
            lambda: parallel.sharded_spmv(mesh, lap_rows, xv).cpu(),
            lambda: sdt.dot_product(dev["lap"], xv),
            both("sharded_spmv", lap @ xv, 6), ("K3_csr_spmv",))
        run("sharded_spmv_halo", shape_lap + ", halo 1",
            lambda: parallel.sharded_spmv_halo(mesh, lap_rows, xv, halo=1),
            lambda: sdt.dot_product(dev["lap"], xv),
            both("sharded_spmv_halo", lap @ xv, 6), ("K3_csr_spmv",))

        def cg_check(got, mine):
            x_cg, res, iters = got
            # Stopped at ||r|| <= 1e-10 on the recurrence; the true
            # residual drifts by ~eps ||A|| ||x|| per step (phase 5's
            # Krylov bound).
            rel = rel_residual(lap, x_cg, xv)
            if not rel <= 1e-9:
                raise AssertionError(f"sharded_cg: relative residual {rel}")
            return {"max_abs_err_vs_single": array_err(
                "sharded_cg vs single", x_cg, mine[0], 6),
                "rel_residual": rel, "residual": res, "iterations": iters}

        def single_cg(a, b):
            with sdt.CGIterativeSparseSolver(a, b, a_tol=1e-10, r_tol=0.0,
                                             n=a.shape[1]) as solver:
                return solver.solve(), solver.final_code

        run("sharded_cg", shape_lap + ", atol 1e-10",
            lambda: parallel.sharded_cg(mesh, lap_rows, xv, tol=1e-10),
            lambda: single_cg(dev["lap"], xv), cg_check, ("K3_csr_spmv",))
        x_grid = parallel.shard_csr_grid(x, 1, mesh)
        x_t = parallel.shard_csr_krows(x.T.tocsr(), 1, mesh)
        run("sharded_spgemm_demo", "demo X @ X.T, panels 500 x 500",
            lambda: parallel.sharded_spgemm(mesh, x_grid, x_t),
            lambda: sdt.dot_product(dev["x"], dev["xT"]),
            both("sharded_spgemm_demo", x @ x.T, 6, sparse_err),
            ("K6_csr_spgemm_dense",))
        a1_k = parallel.shard_csr_krows(a1, 1, mesh)
        run("sharded_spgemm_config1", "config 1 A @ A, panels 10k x 10k "
            "(f64 + f32)",
            lambda: parallel.sharded_spgemm(mesh, grid, a1_k),
            lambda: sdt.dot_product(dev["a1"], dev["a1"]),
            both("sharded_spgemm_config1", a1 @ a1, 6, sparse_err),
            ("K6_csr_spgemm_dense",))
        x_rows = parallel.shard_csr_rows(x, 1, mesh)
        gram = (x.T @ x).toarray()
        run("sharded_gram", "demo X^T X, 5000^2 f64",
            lambda: parallel.sharded_gram(mesh, x_rows).cpu(),
            lambda: sdt.gram_matrix(dev["x"], dense=True),
            # the single-device gram keeps the upper triangle (reference)
            lambda got, mine: {
                "max_abs_err_vs_single": array_err(
                    "sharded_gram vs single", np.triu(host(got)), mine, 6),
                "max_abs_err_vs_scipy": array_err(
                    "sharded_gram vs scipy", host(got), gram, 6)},
            ("K6_csr_spgemm_dense",))
        cgls_rows = parallel.shard_csr_rows(cgls_a, 1, mesh)
        shape5 = "config 5: 1.2M x 50k, 4.65 M nnz + identity tail"

        def lstsq_check(name, rhs):
            def check(got, mine):
                sol = got[0] if isinstance(got, tuple) else got
                rel = normal_residual(cgls_a, sol, rhs)
                if not rel <= 1e-6:
                    raise AssertionError(f"{name}: normal-equation "
                                         f"residual {rel}")
                out = {"max_abs_err_vs_single": array_err(
                    f"{name} vs single", sol, mine, 6),
                    "normal_residual": rel}
                if isinstance(got, tuple):
                    out.update(residual=got[1], iterations=got[2])
                return out
            return check

        run("sharded_cgls", shape5,
            lambda: parallel.sharded_cgls(mesh, cgls_rows, inp["cgls_b"]),
            lambda: sdt.sparse_qr_solve(dev["cgls_a"], inp["cgls_b"]),
            lstsq_check("sharded_cgls", inp["cgls_b"]), ("K3_csr_spmv",))
        for suffix, rhs in (("", inp["cgls_b"]), ("_4rhs", inp["cgls_b4"])):
            run("sparse_qr_solve_sharded" + suffix, shape5,
                lambda rhs=rhs: sdt.sparse_qr_solve(cgls_rows, rhs),
                lambda rhs=rhs: sdt.sparse_qr_solve(dev["cgls_a"], rhs),
                lstsq_check("sparse_qr_solve_sharded" + suffix, rhs),
                ("K3_csr_spmv",))
    for kernel in ("K2_csr_spmm", "K3_csr_spmv", "K6_csr_spgemm_dense"):
        if not totals[kernel]:
            raise AssertionError(f"phase 7 launched no {kernel}")
    emit("7-comm", card=card, collectives=collective_times(mesh, lap.shape[0],
                                                           cgls_a.shape[1]))
    parallel.shutdown()
    emit("7-launches", launches=totals, card=card,
         timer="host clock, host in to host out, median (min, max) of "
               f"{SHARDED_REPS} after a checked first call, the "
               "single-device port (operand on the card) in the same "
               "turns; device busy: torch.profiler, one more call")
    return totals


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", choices=("spgemm", "k6", "k7", "k8", "k9", "k11",
                           "sharded", "batched", "groups", "densify",
                           "bsr"),
        help="a short run that ends with no result line: spgemm runs "
             "phases 1, 2 (K4-K6 and K2/K3's complex inf case), 3 and 4 of "
             "sparse x sparse; k6 runs phase 1 and K6's phase-4 rows "
             "(k6_timings); k7 runs phase 1, K7's phase-2 checks, its "
             "phase-4 rows and phase 6's config-1 f64 steps; k8 (k9) runs "
             "phase 1, K8's (K9's) phase-2 checks, its phase-4 rows and "
             "its phase-6 runs (bsr_training and bsr_hvp; "
             "spgemm_training and spgemm_dense_hvp); k11 the same for "
             "K11 (its phase-2 checks with csr_spgemm's gradcheck and "
             "check_second_order, k11_rows, spgemm_sparse_training, "
             "spgemm_sparse_hvp and hessian_vector_product); sharded runs "
             "phase 1 and phase 7 (sharded_path); batched runs phase 1, "
             "the batched launches' phase-2 checks (check_batched), their "
             "phase-4 rows and phase 6's batched runs; groups runs phase "
             "1, the member groups' phase-2 checks (check_groups), "
             "batched K1's (config 3), K2's, K5's and K6's phase-4 rows "
             "and phase 6's batched runs; densify runs "
             "phase 1, K12's phase-2 checks (check_k12), phase 3's "
             "densify calls (densify_path), K12's phase-4 rows and the "
             "crossover sweep (densify_sweep); bsr runs phase 1, K1's and "
             "K8's phase-2 checks (single and batched, every variant), "
             "their phase-4 rows (single and batched) and phase 6's BSR "
             "runs (bsr_training and bsr_hvp)")
    only = parser.parse_args().only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(2)

    from sparse_dot_tpu_torch.config import config
    from sparse_dot_tpu_torch.ops import _build, dense

    config.device = "cuda"
    dense.ieee_matmul()
    if LOG:
        os.makedirs(os.path.dirname(os.path.abspath(LOG)), exist_ok=True)
        open(LOG, "w").close()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    emit(1, card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         nvcc_seconds=_build.build_seconds,
         build_and_load_seconds=time.perf_counter() - t0,
         library_hash=_build.source_hash())

    if only == "spgemm":
        check_kernels(spgemm_only=True)
        spgemm_timings(spgemm_path()[1])
        return
    if only == "k6":
        emit("4-k6", rows=k6_timings(spgemm_inputs()),
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each")
        return
    if only == "k7":
        check_k7()
        inputs = path_inputs()
        rows = []
        k7_rows(rows, inputs, np.random.default_rng(SEED + 4))
        emit("4-k7", rows=rows,
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; library and beside timed in the same turns")
        k7_training(inputs)
        return
    if only in ("k8", "k9"):
        kernel = only.upper()
        results, lanes = check_k8_k9((kernel,))
        emit(2, kernels=results, k9_lanes=lanes or None)
        inputs = path_inputs() if kernel == "K8" else None
        spgemm_inp = (spgemm_inputs() if kernel == "K9"
                      else dict.fromkeys(("x", "a1m")))
        rows = []
        if kernel == "K8":
            k8_rows(rows, inputs, np.random.default_rng(SEED + 4))
        else:
            rows = k9_rows(spgemm_inp)
        emit(f"4-{only}", rows=rows,
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; yardstick timed in the same turns")
        grad_training(inputs, spgemm_inp, (kernel,))
        return
    if only == "k11":
        results, lanes, launched = check_k11_all()
        emit(2, kernels=results, k11_lanes=lanes,
             k11_gradcheck_launches=launched,
             gradgradcheck_launches=check_second_order())
        spgemm_inp = spgemm_inputs()
        emit("4-k11", rows=k11_rows(spgemm_inp),
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; yardstick and beside timed in the same turns")
        grad_training(path_inputs(), spgemm_inp, ("K11",))
        return
    if only == "sharded":
        sharded_path(sharded_inputs(path_inputs(), solver_inputs()))
        return
    if only == "densify":
        results = {name: {"cases": 0, "max_abs_err": 0.0} for name in (
            "K12_csr_densify", "K12_csr_indicator", "K13_csr_compact")}

        def record(name, err):
            results[name]["cases"] += 1
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)

        emit(2, kernels=results, k12_paths=check_k12(record),
             k13_paths=check_k13(record))
        densify_path()
        emit("4-k12", rows=k12_rows(path_inputs(), solver_inputs())
             + k13_rows(),
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; library, yardstick and beside timed in the same "
                   "turns")
        densify_sweep()
        return
    if only == "bsr":
        results = {name: {"cases": 0, "max_abs_err": 0.0}
                   for name in KERNELS if name.startswith(("K1_", "K8_"))}

        def record(name, err):
            results[name]["cases"] += 1
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)

        rng = np.random.default_rng(SEED)
        for tdt, npdt in NP_DTYPES.items():
            for itype in (np.int32, np.int64):
                check_k1(rng, tdt, npdt, itype, record)
            check_bsr_batched(rng, tdt, npdt, np.int32,
                              0.5 - 0.25j if tdt.is_complex else -1.5,
                              record)
        check_k1_special(rng, record)
        k8, _ = check_k8_k9(("K8",))
        for name, got in k8.items():
            results[name] = {
                "cases": results[name]["cases"] + got["cases"],
                "max_abs_err": max(results[name]["max_abs_err"],
                                   got["max_abs_err"])}
        emit(2, kernels=results)
        inputs, rows = path_inputs(), []
        rng = np.random.default_rng(SEED + 4)
        k1_rows(rows, inputs)
        k8_rows(rows, inputs, rng)
        bsr_batched_rows(rows, inputs, rng)
        emit("4-bsr", rows=rows,
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; library, yardstick and beside timed in the same "
                   "turns")
        grad_training(inputs, dict.fromkeys(("x", "a1m")), ("K8",))
        reset_launches()
        runs, errs = {}, {}
        complex_bsr_vmap(inputs, runs, errs)
        emit("6-vmap", runs=runs, max_abs_err_vs_plain=errs,
             batched_launches=read_batched())
        return
    if only == "groups":
        results = {name: {"cases": 0, "max_abs_err": 0.0}
                   for name in ("K1_bsr_spmm_tc", "K2_csr_spmm",
                                "K5_csr_spgemm_fill", "K6_csr_spgemm_dense")}

        def record(name, err):
            results[name]["cases"] += 1
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)

        emit(2, kernels=results, groups=check_groups(record))
        inputs, rows = path_inputs(), []
        batched_rows(rows, inputs, np.random.default_rng(SEED + 4))
        spgemm_inp = spgemm_inputs()
        rows = [r for r in rows if r["kernel"] == "K2_csr_spmm"
                or r["shape"].startswith("batched: config3")]
        rows += batched_spgemm_rows(spgemm_inp, groups_only=True)
        emit("4-groups", rows=rows,
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; library, yardstick and beside timed in the same "
                   "turns")
        batched_training(inputs, spgemm_inp)
        return
    if only == "batched":
        results = {name: {"cases": 0, "max_abs_err": 0.0}
                   for name in KERNELS}

        def record(name, err):
            results[name]["cases"] += 1
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)

        paths, spgemm_seen = check_batched(record)
        emit(2, kernels={k: v for k, v in results.items() if v["cases"]},
             batched_16_byte_paths=paths, batched_spgemm_seen=spgemm_seen)
        inputs, rows = path_inputs(), []
        batched_rows(rows, inputs, np.random.default_rng(SEED + 4))
        spgemm_inp = spgemm_inputs()
        rows += batched_spgemm_rows(spgemm_inp)
        emit("4-batched", rows=rows,
             timer="cuda events, median (p10, p90), 1 GiB read before "
                   "each; library, yardstick and beside timed in the same "
                   "turns")
        batched_training(inputs, spgemm_inp)
        return
    check_kernels()
    by_path, k10 = {}, {}
    (by_path["dot_product"], inputs), k10["dot_product"] = sorts_in(
        main_path)
    by_path["densify"], k10["densify"] = sorts_in(densify_path)
    (by_path["spgemm"], spgemm_inp), k10["spgemm"] = sorts_in(spgemm_path)
    solver_inp = solver_inputs()
    # The densify rows and the sweep first, in the state ``--only densify``
    # measures them in (no profiler trace taken yet), so that the sweep's
    # points and the gate's fit compare between the two.
    densify_rows = k12_rows(inputs, solver_inp) + k13_rows()
    emit("4-k12", rows=densify_rows,
         timer="cuda events, median (p10, p90), 1 GiB read before each; "
               "library, yardstick and beside timed in the same turns")
    densify_sweep()
    rows = (timings(inputs, solver_inp) + spgemm_timings(spgemm_inp)
            + densify_rows + [k10_row(inputs)])
    (by_path["solvers"], records), k10["solvers"] = sorts_in(solver_path,
                                                             solver_inp)
    solver_timings(records, rows)
    training, k10["training"] = sorts_in(training_path, inputs)
    batched = {"training": read_batched()}
    grad, sorts = sorts_in(grad_training, inputs, spgemm_inp)
    k10["training"] += sorts
    by_path["training"] = {name: training[name] + grad[name]
                           for name in KERNELS}
    by_path["vmap"], k10["vmap"] = sorts_in(batched_training, inputs,
                                            spgemm_inp)
    batched["vmap"] = read_batched()
    by_path["sharded"], k10["sharded"] = sorts_in(
        sharded_path, sharded_inputs(inputs, solver_inp))
    emit("4-k10", row=next(r for r in rows
                           if r["kernel"] == "K10_coo_to_sorted_csr"),
         sorts_by_path=k10)
    launches = {name: sum(path[name] for path in by_path.values())
                for name in KERNELS}

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    summary = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        summary.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "launches_by_path": {path: n[name] for path, n in by_path.items()},
            "launches_batched_by_path": {
                path: n.get(name, 0) for path, n in batched.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
            "bound_ms": mine[0]["bound_ms"], "bound_by": mine[0]["bound_by"],
            "library_ms": mine[0]["library_ms"], "shape": mine[0]["shape"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
