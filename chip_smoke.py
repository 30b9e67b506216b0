"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed on its own line:
 1. build the CUDA kernels from gym_so100_tpu_torch/csrc with one nvcc call
    (sm_90a) and print each kernel's ptxas lines (registers, spills), the Newton
    kernel's for each instantiated nv and for its runtime-nv kernel;
 2. print the card's name and power limit (nvidia-smi);
 3. print each kernel's launch shape (envs per block, threads, dynamic
    shared memory); check each kernel against its plain PyTorch version
    on the card, on the inputs of real states of the 4096-env batch
    (float32, hull contacts on, K = 16): at touchdown (the first control
    step after the third at which at least half the envs have a contact)
    and after 12 control steps (the cube landed, the arm reaching the cube
    and the table), and time both on the latter; the hull kernel at 2 and
    at 1 envs per block on the latter's poses, its tables padded with
    copies of geoms that no pair names (launch shape and bit-equality);
 4. run BatchedEnv(num_envs=4096, device="cuda"): reset, then control steps
    with seeded random actions and one autoreset; assert finite results and
    that each kernel launched exactly 10 times per control step; time the
    env-steps per second after a warm-up;
 5. train: Trainer.train on so100_touch_cube at 128 envs, K = 32, utd 8,
    full-width SAC (2 warm-up and 8 learning env-batch steps); assert
    finite metrics, the buffer's size, 10 launches of each kernel per
    control step and ncon within K; check and time both kernels on the
    trainer env's state at touchdown (K = 32); save, restore (bit-equal)
    and take one resumed step; print the training env-steps/s and the time
    of one SAC update (CUDA events);
 6. pixels, at the JAX pixel learning artifact's setting (so100_touch_cube,
    48x64 top-camera frames, 128 envs, K = 32): (a) BatchedEnv in
    "pixels_agent_pos" mode, counted: reset, then control steps with seeded
    random actions, half the envs auto-resetting on the first; assert obs
    shapes and dtypes, finite agent_pos, terminal frames that differ from
    the reset frames at the done envs, 10 launches of each kernel per
    control step; hold the card's frames of 16 envs against the same
    renderer on the CPU (at most 0.2% of a frame's pixels more than 1 apart)
    and the red cube's centroid against its projection (within 4 px); time
    a batched render (CUDA events) and a pixel control step; (b) pixel
    training as in 5 (2 warm-up and 8 learning env-batch steps, utd 8,
    full-width SAC, buffer 50,000 with uint8 frames), counted, with save,
    restore (bit-equal) and a resumed step; time one pixel SAC update;
 7. HER, at the JAX HER artifact's configuration (so100_cube_to_bin, 256
    envs, K = 32, utd 16, batch 256, 256 episodes, ratio 0.8, near-cube
    goals, goal_min_dist 0.02, full-width SAC), cut to 8 env-batch steps
    (2 warm-up) of 3-step episodes, counted: 10 launches of each kernel
    per control step, every lane's episodes flushed twice (256 stored,
    cursor >= 512), finite metrics, ncon within K; save, restore
    (bit-equal) and one resumed step whose counter continues without
    warm-up; the HER env-steps/s and one HER update (sample + SAC update)
    by CUDA events; the HER env's state run on to the cube's touchdown
    (the cut episodes end before it), and both kernels checked against
    their plain versions there (B = 256, K = 32) and timed;
 8. EE: CartesianBatchedEnv on the mocap-weld scene, 1024 envs, K = 32,
    gained weld, "follow" mode, counted: 10 control steps moving each
    target along its own unit direction, 10 holding it; the target moved
    5 cm, ee_err finite, the first 8 lanes within 2.5 cm of their target
    and moved > 2 cm along their direction (the JAX tracking test's
    criteria); both kernels against their plain versions on the state
    after the moves, with the weld's equality rows (neq = 6) in the solve,
    and timed; one EE control step timed;
 9. the single env, counted: make("gym_so100_tpu/SO100TouchCube-v0",
    dtype=float64) on the card at its registered width (640x480 pixels +
    agent_pos, ccd manifolds, K = 32), reset(seed), 8 control steps with
    seeded actions through the cube's landing (a step with active
    manifold contacts); the same steps through the port on the CPU, the
    state obs held to the larger of 1e-10 (the float64 parity tests'
    tolerance) and twice the spread of the CPU run against itself with its
    start moved one ulp; the float32 SO100Env (state obs) for the same
    steps; SO100GoalEnv reset and 2 steps; neither kernel launches in the
    phase; ms per control step (float64, float32, and the CPU's), ms per
    640x480 render (CUDA events) and the phase's wall time, beside the card;
10. multi-GPU, the training phase's configuration at DIST_ENVS = 256 envs
    and 2 warm-up + 2 learning env-batch steps: Trainer(group=...) on 2
    ranks that share the card (processes started with
    torch.multiprocessing, gloo, since NCCL refuses two ranks on one
    device; they load phase 1's library), then on 1 rank over NCCL; per
    rank, counted: 10 launches of each kernel per control step, both
    kernels against their plain versions on its shard at touchdown,
    parameters bit-equal across ranks; the 2 ranks' warm-up transitions
    against the NCCL run's (actions equal, obs within DIST_OBS_TOL); the
    sharded env-steps/s; then on each run's trained learner
    SAC.update(group=...) on the rank's rows of a whole-batch sample
    against the full update on that batch (parameters within
    DIST_UPDATE_TOL, losses within DIST_LOSS_RTOL, ranks bit-equal, the
    update without the average outside the bound), and both timed (host
    clock, DIST_UPDATE_REPS updates);
11. the Panda EE scene (float32, K = 24) on the card: the mocap target on
    the ee for 4 control steps, then 3 cm along +x for 8: finite, the
    fingers coupled (|q1 - q2| < 5e-3), the ee moving > 1.5 cm along +x;
    held to the same steps on the CPU (PANDA_TOL); the bound's witnesses:
    it lies above twice the card's own spread under a one-ulp move of the
    start and below the card's run with the finger-coupling equality
    dropped (a planted fault), and the first PANDA64_STEPS in float64 hold
    the card to the CPU as phase 9 does; neither kernel launches;
12. profiling.trace around one 4096-env control step: the trace holds both
    kernels (10 launches each) and the five stages' marks (10 each: the
    substeps are replays of a CUDA graph, which run no host range); the summed
    device time of its kernels, copies and sets against the step's wall
    time (the device-busy share);
13. the batch-first narrowphase on phase 3's state after 12 control
    steps (4096 envs, float32, K = 16): position_stage_batched once,
    counted (exactly 1 hull-sweep launch, no solve); its Contact against
    collide_batched_lanes on the same Data, transposed (active, geom ids,
    condim and ncand equal; dist, pos and frame within JAX's tolerances);
    make_efc_batched against make_efc_from_lanes, transposed (bit-equal
    but the tangent rows' J and aref of contacts whose two frames differ
    by rounding, there within 1e-6 and 1e-5 of scale); 64 envs again
    on the CPU, where the route runs sweep_h_plain, from the card's geom
    poses (slot by slot, JAX's tolerances) and from the state (the
    contacts as sets, BF_CPU_TOL); the route, its collide stage, the lanes
    collide and the hull kernel on its inputs timed with CUDA events;
14. the batched lanes step of the Panda EE scene (float32, K = 24, nv =
    15: the Newton kernel's nv = 15 build, the hull kernel at G = 31, P =
    256, 4 envs per block): forward.n_steps_batched at 1024 envs from
    "home" with each env's arm joints moved by a seeded draw of at most
    0.01 rad, 2 control steps holding each mocap target on its ee, then 6
    after moving it 3 cm along +x, counted (10 launches of each kernel per
    control step); finite, the fingers coupled in every lane, the first 8
    lanes' ee moved > 1.5 cm along +x; both kernels against their plain
    versions on the state after the move (hull tables bit-equal, the
    Newton solve by the floor rule) and timed; the first 8 lanes held to
    the same steps on the CPU within PB_TOL, which lies above twice the
    card's own one-ulp spread and below a planted fault (the finger
    coupling dropped); the control step timed;
15. the batched lanes step of the five-cube SO100 scene
    (write_multicube_scene: so100_transfer_cube.xml and four free cubes
    resting on the table; float32, K = 32, nv = 36: the Newton kernel's
    runtime-nv build; the hull kernel at G = 29, P = 169) at 4096 envs, 4
    control steps from qpos0 with each env's arm joints moved by a seeded
    draw of at most 0.01 rad, counted (10 launches of each kernel per
    step); finite, ncon within K, the resting cubes within 5 mm of z = 0.02;
    both kernels against their plain versions on the state after them (the
    hull tables bit-equal, the Newton solve by the floor rule, which the
    kernel on rows with one cube's J zeroed must miss), timed; then the
    one-extra-cube scene (nv = 18) at 1024 envs the same way, the Newton
    kernel checked and timed there; the runtime-nv kernel's launch shape
    (one env per block), its ptxas lines and, at nv = 36, the mean Newton
    iteration count and the mean over groups of 4 consecutive envs of
    their largest (the iterations a block of 4 envs would wait for);
16. the chain probe (scripts/probe_chain.py, the port of
    devtools/probe_pallas.py) at its B = 4096 on the probe's inputs: the
    kernel csrc/chain_probe.cu against chain_plain on the card at n = 50
    and n = 10, bit-equal on the finite components, the non-finite ones
    the same set with the same infinities, every lane finite at n = 10;
    one launch per call, counted; then the probe's rows (a) eager
    chain_body_fn at n = 50, with the device kernels of one call counted
    in a profiler trace, (b) at n = 200 and the cost of one more iteration,
    (d) the kernel, and (p) chain_plain, counted, by CUDA events, and the
    kernel's device time per launch at n = 0, 50 and 200 from a profiler
    trace of each: its fixed cost (n = 0), its time per iteration (the slope from
    50 to 200) in ns and in cycles at the SM clock measured in the run, its
    launch shape, ptxas lines, and its bound: the largest of the bytes, the
    operations at the rate without multiply-add, and the chain of dependent
    operations at the latency and clock csrc/chain_latency.cu measures;
17. print the build, ptxas, launch-shape and check lines again (so that
    the end of the output holds them), the kernel table as one JSON line
    (per kernel: the K = 16 row, the statistic its check bounds with that
    bound, the training phase's launches, check and times under
    "train_k32", the launches of the pixel env and pixel training under
    "pixel_env" and "train_pixels", the HER phase's launches, check and
    times under "her", and the EE phase's launches, check, times and neq
    under "ee", the multi-GPU phase's per-rank launches and times under
    "dist", the batch-first phase's launches and times under
    "batch_first", the batched Panda phase's launches, check, times
    and nv under "panda_batched", and the hull kernel's 2- and 1-env
    blocks under "padded" and its five-cube launches, check and times under
    "multicube"; then a row of the runtime-nv Newton kernel from the
    five-cube phase, with its nv = 18 check and times under "nv18"; then
    the chain probe's row, with its probe rows under "probe"), the
    single-env, Panda, batched Panda, five-cube and trace phases' numbers as
    a JSON line before it, the card, then the result line
    {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA device, or outside a checkout of the repository, it exits
with code 2 before doing anything.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

NUM_ENVS = 4096
MAX_CONTACTS = 16
TASK = "so100_touch_cube"
SEED = 0
WARM_STEPS = 3        # control steps before the search for touchdown
TOUCHDOWN_MAX = 10    # ... which may take this many more
LANDED_STEPS = 12     # control steps before the second kernel checks
FLOOR_SAMPLES = 8     # perturbed plain solves that set the second check's floor
MAIN_STEPS = 6        # control steps of the counted main-path run
TIMED_STEPS = 10      # control steps timed for env-steps/s
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
EPS32 = 1.1920929e-07        # float32 machine epsilon
HULL_REL_BOUND = 1e-6        # hull tables: max |kernel - plain| / max(|plain|, 1)
# the training phase: the JAX learning artifact's configuration
# (so100_touch_cube, 128 envs, utd 8, K = 32), full-width SAC
TRAIN_ENVS = 128
TRAIN_K = 32
TRAIN_UTD = 8
TRAIN_WARMUP = 2      # env-batch steps of random actions (learning_starts)
TRAIN_STEPS = 10      # env-batch steps in all: 2 warm-up, 8 learning
UPDATE_REPS = 20      # SAC updates timed with CUDA events
# the pixel phase: the JAX pixel learning artifact's configuration
# (so100_touch_cube, pixels 48x64, 128 envs, utd 8, K = 32)
PIX_H, PIX_W = 48, 64
PIX_STEPS = 3         # control steps of the counted pixel-env run
PIX_CPU_ENVS = 16     # envs whose frames are rendered again on the CPU
PIX_FRAME_TOL = 0.002     # share of a frame's pixels allowed > 1 LSB off the CPU's
RENDER_REPS = 10      # batched renders timed with CUDA events
# the HER phase: the JAX HER artifact's configuration (so100_cube_to_bin,
# 256 envs, K = 32, utd 16, batch 256, lr 1e-4, 256 episodes, ratio 0.8,
# near-cube goals only, goal_min_dist 0.02), full-width SAC; cut to 8
# env-batch steps (2 warm-up) of 3-step episodes (300 in the artifact)
HER_ENVS = 256
HER_UTD = 16
HER_EPISODES = 256
HER_WARMUP = 2
HER_STEPS = 8
HER_EP_STEPS = 3
HER_MIN_DIST = 0.02
# the EE phase: CartesianBatchedEnv at the JAX class docstring's 1024 envs,
# K = 32, gained weld, "follow" mode; the JAX tracking test's moves
EE_ENVS = 1024
EE_MOVE_STEPS = 10    # 0.5 x a unit direction (z >= 0) per control step
EE_HOLD_STEPS = 10
EE_TRACKED = 8        # lanes held to the JAX test's criteria
# the single-env phase: the registered SO100TouchCube-v0 at its full width
# (640x480 pixels + agent_pos, float64 with ccd manifolds, K = 32)
SINGLE_ID = "gym_so100_tpu/SO100TouchCube-v0"
SINGLE_STEPS = 8      # control steps; the cube lands in the 4th
GOAL_STEPS = 2
SINGLE_TOL = 1e-10    # the float64 parity tests' tolerance (the contract of the floor rule)
SINGLE_RENDER_REPS = 5
# the multi-GPU phase: the training phase's configuration (so100_touch_cube,
# K = 32, utd 8, full-width SAC) at 256 envs over 2 ranks that share the
# card (gloo: NCCL refuses two ranks on one device), then one rank over NCCL
DIST_ENVS = 256
DIST_RANKS = 2
DIST_WARMUP = 2
DIST_STEPS = 4        # env-batch steps: 2 warm-up, 2 learning
# the ranks' warm-up transitions against the one-rank run's: the same
# spawns, actions and float32 operations, on 128 instead of 256 envs, where
# torch's reductions and cuBLAS may pick another order per batch width, so
# rows can part by a few ulps per operation; two control steps (20
# substeps of position servos, before the cube lands) keep that well under
# 1e-5, while a wrong row order or spawn moves obs by 1e-2 or more
DIST_OBS_TOL = 1e-4
# SAC.update(group=...) on each rank's rows of a sampled batch against the
# full update on it, after the run's 16 updates: the batch means round in
# another order, which moves an Adam step of lr = 1e-4 by an ulp or two of
# the parameters (|p| < 1, ulp <= 6e-8); a rank that skipped the average
# would move them by ~1e-5; the losses, differences of close Q values,
# keep a few ulps relative to their small differences
DIST_UPDATE_TOL = 1e-6
DIST_LOSS_RTOL = 1e-5
DIST_UPDATE_REPS = 10
# the Panda phase: the EE scene in float32 from its "home" keyframe, the
# mocap target on the ee for PANDA_HOLD control steps, then 3 cm along +x
PANDA_K = 24
PANDA_HOLD = 4
PANDA_MOVE = 8
# the card's float32 steps against the CPU's: the float32 single-env Newton
# solve stops at its float32 tolerance within 10 iterations, and another
# rounding order (the card's reductions and libm) moves where it stops
# (9.4e-4 rad after the 12 steps on an NVIDIA H100 80GB HBM3, 700 W); the
# phase shows that the bound lies above twice the card's own one-ulp
# spread and below a planted fault (the finger coupling dropped)
PANDA_TOL = 5e-3
# the float64 witness, held as phase 9 holds the SO100 (the larger of
# 1e-10 and twice the CPU run's one-ulp spread), over the first control
# step only: from the second on, the float64 run's own one-ulp spread
# grows to millirads
PANDA64_STEPS = 1


# the batch-first phase: position_stage_batched on phase 3's landed state
BF_CPU_ENVS = 64      # envs run again on the CPU
BF_REPS = 5           # calls timed with CUDA events
# JAX's float32 contract of collide_batched against its lanes form
# (tests/test_lanes.py): dist, pos, frame (rtol, atol)
BF_TOL = {"dist": (1e-6, 1e-7), "pos": (1e-6, 1e-6), "frame": (1e-5, 1e-6)}
# the CPU's kinematics against the card's: CUDA's and the host libm's
# float32 sin/cos differ by an ulp or two, which the arm's chain of bodies
# carries into the geom poses (the CPU tests hold XLA's to torch's within
# 2e-6); poses, and the matched contacts' depth, point and normal
BF_CPU_TOL = 1e-5
# the batched Panda phase: forward.n_steps_batched on the Panda EE scene
# (float32, K = PANDA_K, nv = 15) at 1024 envs, the phase-11 moves
PB_ENVS = 1024
PB_JITTER = 0.01      # rad: a seeded draw on each env's arm joints
PB_TRACKED = 8        # lanes held to the JAX test's criteria and to the CPU
# the first PB_TRACKED lanes against the same steps on the CPU (the plain
# solve there): as PANDA_TOL, the bound must lie above twice the card's own
# spread under a one-ulp move of the start and below a planted fault (the
# finger coupling dropped, 0.178 after the 4 hold steps).  The batched
# step parts from itself far more than the single env (1.2e-3): one-ulp
# moves of the start grew to 2.25e-2 over the 12 steps on an NVIDIA H100
# 80GB HBM3 (700 W).  The phase logs where, by joint and by lane: the 6-dof
# weld leaves the 7-dof arm one null-space motion (turning the arm about
# its ee), which only the joint servos hold
PB_TOL = 0.1
# phase 14 runs shorter moves than phase 11 (PANDA_HOLD, PANDA_MOVE): 2
# hold and 6 move control steps, in which the tracked ee still move > 1.5
# cm along +x (1.76-2.28 cm on the CPU) and the dropped finger coupling
# still lies past PB_TOL (0.156 after the 2 hold steps on the CPU)
PB_HOLD = 2
PB_MOVE = 6
# the five-cube phase: so100_transfer_cube.xml with MC_CUBES more free
# cubes resting on the table (nv = 12 + 6 * MC_CUBES = 36: the Newton
# kernel's runtime-nv build), float32, K = 32, at the env-step phase's
# width, from qpos0 with each env's arm joints moved by a seeded draw of at
# most MC_JITTER rad; `box` falls from 5 cm and lands at about the 4th step
MC_CUBES = 4
MC_ENVS = 4096
MC_K = 32
MC_STEPS = 4
MC_JITTER = 0.01
MC_REST_TOL = 5e-3    # m: the resting cubes' height from 0.02
MC18_ENVS = 1024      # the one-extra-cube scene (nv = 18)
# phase 16: the chain probe (scripts/probe_chain.py), at its own B = 4096
CHAIN_SHORT = 10     # iterations after which every lane of the probe's inputs is finite

RECAP = []   # the build, launch-shape and check lines, printed again at the end


def write_multicube_scene(directory, cubes=MC_CUBES):
    """Write so100_transfer_cube.xml (included by its absolute path) with
    `cubes` more free bodies cube0.. resting on the table at (-0.15 + 0.06 i,
    0.30, 0.021), each with `box`'s joint frictionloss, inertial and geom
    attributes and a 0.02 half-size box, into `directory`; returns the path.
    nv = 12 + 6 * cubes."""
    base = Path(__file__).resolve().parent / "gym_so100_tpu" / "assets" / "so100_transfer_cube.xml"
    bodies = "".join(f"""
        <body name="cube{i}" pos="{-0.15 + 0.06 * i:.2f} 0.30 0.021">
            <joint name="cube{i}_joint" type="free" frictionloss="0.01" />
            <inertial pos="0 0 0" mass="0.05" diaginertia="0.002 0.002 0.002" />
            <geom condim="4" solimp="2 1 0.01" solref="0.01 1" friction="1 0.005 0.0001"
                pos="0 0 0" size="0.02 0.02 0.02" type="box" name="cube{i}_geom"
                rgba="0 0 1 1" />
        </body>""" for i in range(cubes))
    path = Path(directory) / f"so100_transfer_{1 + cubes}_cubes.xml"
    path.write_text(f'<mujoco>\n    <include file="{base}" />\n    <worldbody>{bodies}\n'
                    f'    </worldbody>\n</mujoco>\n')
    return path


def log(msg, recap=False):
    print(msg, flush=True)
    if recap:
        RECAP.append(msg)


def gpu_name_and_power():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        line = res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        line = ""
    return line


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(kernel):
    """The ptxas lines (spills, registers) of the kernel whose mangled
    name contains `kernel`, from the last build's log (none if it was
    cached)."""
    from gym_so100_tpu_torch import kernels

    out, inside = [], False
    for line in kernels.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def log_shape(name, shape, B):
    envs, threads, smem = shape
    blocks = -(-B // envs)
    log(f"{name} launch: {envs} envs per block, {threads} threads, {smem} B dynamic "
        f"shared memory, {blocks} blocks at B = {B}", recap=True)


def hull_inputs(m, d):
    """The hull sweep's inputs for the geom poses of `d`, as
    hull_lanes.collide_hulls_lanes packs them: p and R as (G, B) lanes,
    and their packed forms (3G, B) and (9G, B)."""
    import torch

    from gym_so100_tpu_torch.ops.collision import hull_lanes

    tb = hull_lanes.hull_tables(m)
    gx = d.geom_xpos[:, tb.gidx, :]
    gm = d.geom_xmat[:, tb.gidx, :, :]
    p = [gx[..., k].T for k in range(3)]
    R = [[gm[..., j, k].T for k in range(3)] for j in range(3)]
    p_pack = torch.cat(p).contiguous()
    R_pack = torch.cat([R[j][k] for j in range(3) for k in range(3)]).contiguous()
    return p, R, p_pack, R_pack


def check_hull(env, es, timed):
    """Kernel 1 against sweep_h_plain on the geom poses of `es`: the same
    float32 operations in the same order, so the results must be equal
    (checked to 1e-6 abs/rel on depth and normal, active masks equal,
    witness positions to 1e-5)."""
    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.ops.smooth_lanes import kinematics

    m = env.m
    tb = hull_lanes.hull_tables(m)
    p, R, p_pack, R_pack = hull_inputs(m, kinematics(m, es.physics))
    args = (p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)
    out_k = hull_lanes.sweep_h(p_pack, R_pack, tb)
    out_p = hull_lanes.sweep_h_plain(*args)
    torch.cuda.synchronize()
    P, B = tb.P, p_pack.shape[1]
    split = lambda o: (o[:P], [o[(1 + j) * P:(2 + j) * P] for j in range(3)])
    res_k = hull_lanes._witness_and_pack(m, tb, p, R, *split(out_k))
    res_p = hull_lanes._witness_and_pack(m, tb, p, R, *split(out_p))
    act = res_p[3]
    err = (out_k - out_p).abs()
    max_err = float(err.max())
    rel_err = float((err / out_p.abs().clamp(min=1.0)).max())
    assert torch.equal(res_k[3], act), "hull: active masks differ"
    assert rel_err <= HULL_REL_BOUND, f"hull: depth/normal differ by {max_err}"
    pos_err = max(float((res_k[0][j][act] - res_p[0][j][act]).abs().max())
                  if act.any() else 0.0 for j in range(3))
    assert pos_err <= 1e-5, f"hull: witness positions differ by {pos_err}"
    log(f"hull sweep check: active pairs {int(act.sum())}/{P * B}, depth/normal max "
        f"abs err {max_err:.3g}, witness pos err {pos_err:.3g}", recap=True)
    if not timed:
        return None

    out = torch.empty_like(out_k)
    G, ND = tb.G, tb.D.shape[0]
    Vmax = tb.verts.shape[1] // 3
    log_shape("hull_sweep", kernels.launch_shape("gst_hull_sweep", G, ND, P, tb.vtot), B)
    ms = cuda_ms(lambda: kernels.launch(
        "gst_hull_sweep", *args, out, G, ND, P, Vmax, tb.vtot, B), 50)
    plain_ms = cuda_ms(lambda: hull_lanes.sweep_h_plain(*args), 5)
    # least work: inputs read once, output written once; operations of the
    # sweep (15 for the local direction, 5 per vertex support, 2 per vertex
    # max/min, 5 for d.p, 2 adds) and the pair min (sub + compare per dir)
    counts = tb.counts.tolist()
    nbytes = 4 * (p_pack.numel() + R_pack.numel() + tb.verts.numel() + tb.D.numel()
                  + out_k.numel()) + 4 * (tb.counts.numel() + 2 * P)
    ops = B * ND * (sum(27 + 7 * (v - 1) for v in counts) + 2 * P)
    log(f"hull sweep: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(
        name="hull_sweep", route="cuda",
        source="gym_so100_tpu_torch/csrc/hull_sweep.cu",
        replaces="gym_so100_tpu/ops/collision/hull_lanes.py:221",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        **_bound(nbytes, ops), library_ms=None,
        check_stat="max |kernel - plain| / max(|plain|, 1) over depth and normal",
        check_value=rel_err, check_bound=HULL_REL_BOUND,
    )


def padded_hull_args(tb, p_pack, R_pack, G_pad):
    """The hull sweep's inputs (p, R, verts, D, counts, i1, i2) with the
    tables of `tb` padded to G_pad geoms by copies of its geoms in turn,
    which no pair names: the outputs are those of the unpadded inputs, the
    shared-memory tables larger.  Returns (args, Vtot)."""
    import torch

    G, B = tb.G, p_pack.shape[1]
    idx = torch.arange(G_pad, device=tb.verts.device) % G
    p = p_pack.view(3, G, B)[:, idx].reshape(3 * G_pad, B).contiguous()
    R = R_pack.view(9, G, B)[:, idx].reshape(9 * G_pad, B).contiguous()
    counts = tb.counts[idx].contiguous()
    return (p, R, tb.verts[idx].contiguous(), tb.D, counts, tb.i1, tb.i2), int(counts.sum())


def check_hull_padded(env, es):
    """Kernel 1 at 2 and at 1 envs per block: the geom poses of `es` with
    the tables padded (padded_hull_args) to the fewest geoms at which 4,
    then 2, envs no longer fit a block, launched directly (uncounted); each
    launch shape must show the smaller E, and the output must equal
    sweep_h_plain's on the unpadded inputs bit for bit.  Returns {E: G}."""
    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.ops.smooth_lanes import kinematics

    tb = hull_lanes.hull_tables(env.m)
    _, _, p_pack, R_pack = hull_inputs(env.m, kinematics(env.m, es.physics))
    ref = hull_lanes.sweep_h_plain(p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)
    ND, P, B = tb.D.shape[0], tb.P, p_pack.shape[1]
    Vmax = tb.verts.shape[1] // 3
    counts = tb.counts.tolist()
    sizes = {}
    for G_pad in range(tb.G, 16 * tb.G):
        vtot = sum(counts[g % tb.G] for g in range(G_pad))
        E = kernels.launch_shape("gst_hull_sweep", G_pad, ND, P, vtot)[0]
        sizes.setdefault(E, G_pad)
        if E < 1:
            break
    for E in (2, 1):
        assert E in sizes, f"hull: no table size gives {E} envs per block: {sizes}"
        args, vtot = padded_hull_args(tb, p_pack, R_pack, sizes[E])
        shape = kernels.launch_shape("gst_hull_sweep", sizes[E], ND, P, vtot)
        assert shape[0] == E, shape
        log_shape(f"hull_sweep (G padded to {sizes[E]})", shape, B)
        out = torch.empty_like(ref)
        kernels.launch("gst_hull_sweep", *args, out, sizes[E], ND, P, Vmax, vtot, B)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), f"hull: {E} envs per block differ from the plain version"
    log(f"hull sweep check at 2 and 1 envs per block (G padded to {sizes[2]} and "
        f"{sizes[1]}; {sizes.get(0, 'no')} geoms fit no block): bit-equal to the plain "
        f"version", recap=True)
    return {E: sizes[E] for E in (2, 1)}


def _solver_stats(q, f, n, ref):
    """Per-lane differences from the reference solve, as the contract of
    tests/test_solver_pallas.py reads them."""
    import torch

    qr, fr, nr = ref
    err = (q - qr).abs().amax(1) / max(float(qr.pow(2).mean().sqrt()), 1.0)
    ferr = (f - fr).abs().amax(1) / max(float(fr.pow(2).mean().sqrt()), 1.0)
    return dict(q95=float(torch.quantile(err, 0.95)), qmax=float(err.max()),
                f95=float(torch.quantile(ferr, 0.95)),
                dniter=abs(float(n.float().mean() - nr.float().mean())),
                ndiff=float((n != nr).float().mean()))


def solver_problem(env, es):
    """The solver's inputs at the state `es`: (qM, a0, efc, warmstart)."""
    from gym_so100_tpu_torch.models.scene import Data
    from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes
    from gym_so100_tpu_torch.ops.collision import narrowphase

    m, s = env.m, es.physics
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    cl = narrowphase.collide_batched_lanes(m, d)
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, cl)
    return sl["qM_lanes"], sl["qacc_smooth"], efc, s.qacc_warmstart


def check_solver(env, es, timed, floor_samples=0, fault=None):
    """Kernel 2 against solve_plain on the constraint rows of `es`.

    Both run the same float32 algorithm with sums in different orders, and
    the algorithm has knife edges at rounding level (the sign of the
    directional derivative at a Newton step of exactly 1 in quadratic
    zones, the improvement < tol stop), so lanes can part.  Without
    `floor_samples`, the contract of the JAX package's Pallas-vs-scan test
    is asserted as it stands: qacc p95 < 1e-4, max < 5e-2; qfrc p95 <
    5e-3; mean niter within 0.5; < 25% of lanes with another niter.  With
    `floor_samples` = n, for a state where the plain solve parts from
    itself by more than that contract allows, the plain solve is first
    moved by one ulp of noise on each input (J, aref, D, qM, a0; n
    samples), and every one of those statistics is held to the larger of
    the contract and twice the worst sample (two solves that each lie
    within the floor of the plain one lie within twice it of each other).
    With `fault` (efc -> efc), the kernel on the faulted rows must miss
    some bound: a planted fault that shows the check can fail."""
    import dataclasses

    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.ops import solver_lanes

    m = env.m
    qM, a0, efc, warm = solver_problem(env, es)
    qk, fk, nk = solver_lanes.solve_fused(m, qM, a0, efc, warm)
    ref = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    torch.cuda.synchronize()
    for name, t in (("qacc", qk), ("qfrc", fk), ("niter", nk)):
        assert bool(torch.isfinite(t.float()).all()), f"solver: {name} not finite"
    st = _solver_stats(qk, fk, nk, ref)
    # cone zones of the active contacts at the plain solution
    jar_ref = (efc.J * ref[0].T[:, None]).sum(0) - efc.aref
    cone = solver_lanes._cost_terms(efc, jar_ref)[5]
    act = efc.con_active
    zones = (f"{int(act.sum())} active contacts in {int(act.any(0).sum())}/{act.shape[1]} "
             f"envs, top zone {int((cone['top'] & act).sum())}, middle zone "
             f"{int((cone['middle'] & act).sum())}")
    fmt = lambda x: " ".join(f"{k} {v:.3g}" for k, v in x.items())
    bounds = dict(q95=1e-4, qmax=5e-2, f95=5e-3, dniter=0.5, ndiff=0.25)
    if floor_samples:
        gen = torch.Generator(device=a0.device).manual_seed(SEED + 5)
        ulp = lambda t: t * (1 + EPS32 * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype))
        samples = [_solver_stats(*solver_lanes.solve_plain(
            m, ulp(qM), ulp(a0),
            dataclasses.replace(efc, J=ulp(efc.J), aref=ulp(efc.aref), D=ulp(efc.D)),
            warm), ref) for _ in range(floor_samples)]
        floor = {k: max(x[k] for x in samples) for k in st}
        bounds = {k: max(b, 2 * floor[k]) for k, b in bounds.items()}
        log(f"solver check ({zones}): kernel vs plain: {fmt(st)}; plain vs "
            f"one-ulp-perturbed plain (worst of {floor_samples}): {fmt(floor)}; "
            f"bounds: {fmt(bounds)}", recap=True)
    else:
        log(f"solver check ({zones}): kernel vs plain: {fmt(st)}; bounds: {fmt(bounds)}",
            recap=True)
    for k, bound in bounds.items():
        assert st[k] < bound, f"solver: {k} {st[k]:.3g} >= {bound:.3g}"
    if fault is not None:
        fst = _solver_stats(*solver_lanes.solve_fused(m, qM, a0, fault(efc), warm), ref)
        missed = [k for k in bounds if not fst[k] < bounds[k]]
        log(f"solver check, planted fault: kernel on the faulted rows vs plain: {fmt(fst)}; "
            f"misses the bounds of {missed}", recap=True)
        assert missed, "solver: the planted fault passed the check"
    if not timed:
        return None

    inp = solver_lanes.pack_fused_inputs(m, qM, a0, efc, warm)
    NE, B = efc.aref.shape
    K = efc.con_mu.shape[0]
    out = torch.empty(2 * m.nv + 1, B, device=a0.device)
    shape = kernels.launch_shape("gst_newton_solve", m.nv, NE, efc.neq, efc.nf, efc.nl, K)
    log_shape(f"newton_solve (nv = {m.nv})", shape, B)
    ms = cuda_ms(lambda: kernels.launch(
        "gst_newton_solve", inp["J"], inp["aref"], inp["D"], inp["aux"], inp["us"],
        inp["qM"], inp["x0"], inp["warm"], out, m.nv, NE, efc.neq, efc.nf,
        efc.nl, K, B, *solver_lanes.budgets(m, torch.float32)), 20)
    plain_ms = cuda_ms(lambda: solver_lanes.solve_plain(m, qM, a0, efc, warm), 3)
    # least work: inputs read once, output written once; per executed
    # Newton iteration (this run's niter) the jar, gradient and djar passes
    # (2*nv ops per row each), the Hessian over the rows with nonzero D
    # (nv(nv+1) per row), 13 line-search derivative evaluations (~12 ops per
    # row) and the cost at the new point (2*nv + 6 per row), plus Cholesky
    nv = m.nv
    nbytes = 4 * (sum(t.numel() for t in inp.values()) + out.numel())
    active_rows = (efc.D != 0).sum(0).float()
    per_iter = (NE * (3 * 2 * nv + 13 * 12 + 2 * nv + 6) + active_rows * nv * (nv + 1)
                + nv ** 3 / 3 + 2 * nv * nv)
    ops = float((nk.float() * per_iter).sum())
    log(f"solver: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    n = nk.double()
    return dict(
        name="newton_solve", route="cuda",
        source="gym_so100_tpu_torch/csrc/newton_solve.cu",
        replaces="gym_so100_tpu/ops/solver_lanes.py:635",
        max_abs_err=float((qk - ref[0]).abs().max()), ms=ms, plain_ms=plain_ms,
        **_bound(nbytes, ops), library_ms=None,
        check_stat="max |kernel qacc - plain qacc| / max(rms(plain qacc), 1)",
        check_value=st["qmax"], check_bound=bounds["qmax"], NE=NE, launch_shape=shape,
        niter_mean=float(n.mean()),
        niter_max4_mean=float(n[:B - B % 4].view(-1, 4).amax(1).mean()),
    )


def advance(env, es, steps, gen):
    """`steps` control steps with random actions drawn from `gen`."""
    import torch

    for _ in range(steps):
        actions = torch.rand(env.num_envs, 6, generator=gen, device=env.device) * 2 - 1
        es = env.step(es, actions)[0]
    return es


def _bound(nbytes, ops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def run_main_path(env, steps):
    """reset + `steps` control steps through BatchedEnv with seeded random
    actions; the first 64 envs start one step short of their episode limit,
    so they auto-reset on the first step.  Returns the number of resets."""
    import torch

    gen = torch.Generator(device=env.device).manual_seed(SEED + 2)
    es = env.reset(seed=SEED + 3)
    t = es.t.clone()
    t[:64] = env.max_episode_steps - 1
    es = es.replace(t=t)
    resets = 0
    for i in range(steps):
        actions = torch.rand(env.num_envs, 6, generator=gen, device=env.device) * 2 - 1
        es, obs, reward, term, trunc, info = env.step(es, actions)
        done = term | trunc
        resets += int(done.sum())
        assert obs.shape == (env.num_envs, 15) and obs.dtype == torch.float32
        assert bool(torch.isfinite(obs).all()), f"step {i}: obs not finite"
        assert bool(torch.isfinite(reward).all()), f"step {i}: reward not finite"
        assert bool(torch.isfinite(info["final_obs"]).all())
        assert bool(torch.isfinite(es.physics.qpos).all())
    assert resets >= 64, f"expected the first 64 envs to auto-reset, saw {resets}"
    return resets, es


def stage_times(env, es):
    """Host-clock time of each stage of one substep, with a device
    synchronize after each (so a stage's time includes its device work)."""
    import torch

    from gym_so100_tpu_torch.models.scene import Data
    from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
    from gym_so100_tpu_torch.ops.collision import narrowphase

    m, s = env.m, es.physics
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    for _ in range(2):                      # the second pass is reported
        sl = timed("smooth", lambda: smooth_lanes.forward_smooth_lanes(m, s))
        d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
                 subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"],
                 qacc_smooth=sl["qacc_smooth"])
        cl = timed("collide", lambda: narrowphase.collide_batched_lanes(m, d))
        efc = timed("efc", lambda: constraint_lanes.make_efc_from_lanes(m, d, s, cl))
        q = timed("solve", lambda: solver_lanes.solve_lanes(
            m, sl["qM_lanes"], d.qacc_smooth, efc, s.qacc_warmstart))[0]
        timed("integrate", lambda: smooth_lanes.integrate_lanes(m, s, q))
    total = sum(times.values())
    log("substep stages (host clock, ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()) + f"; total {total:.2f}")


def train_counted(tcfg, sac_cfg, label, keep_states=False):
    """Trainer.train from scratch with both kernels' launch counts set to 0
    just before and read just after; checks the log lines, the update and
    buffer counts, 10 launches of each kernel per control step and ncon
    within K, and prints the throughput.  Returns (trainer, st, launches,
    env states after each step if `keep_states`)."""
    import copy
    import math

    import torch

    from gym_so100_tpu_torch.agents.train import Trainer
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    trainer = Trainer(None, tcfg, sac_cfg, device="cuda")
    assert trainer.env.m.max_contacts == TRAIN_K
    lines, states, stamps = [], [], []

    def progress(line):
        # a log line reads the device, so every step has ended by now
        stamps.append(time.perf_counter())
        lines.append(line)
        if keep_states:
            states.append(copy.deepcopy(trainer.env_state))   # device copies only

    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = trainer.train(seed=SEED, progress=progress)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    log(f"{label}: {TRAIN_STEPS} env-batch steps x {TRAIN_ENVS} envs ({TRAIN_WARMUP} "
        f"warm-up), utd {TRAIN_UTD}, K {TRAIN_K}: {st.step} SAC updates, buffer "
        f"{st.buffer.size}, launches {launches}, last line {json.dumps(lines[-1])}",
        recap=True)
    for name, n in launches.items():
        assert n == 10 * TRAIN_STEPS, f"{label}: {name} {n} launches, expected {10 * TRAIN_STEPS}"
    assert [ln["env_steps"] for ln in lines] == [
        (i + 1) * TRAIN_ENVS for i in range(TRAIN_STEPS)]
    for ln in lines:
        assert all(math.isfinite(v) for v in ln.values()), f"{label}: not finite: {ln}"
    metrics = ("critic_loss", "actor_loss", "alpha", "entropy")
    assert all(set(metrics) <= set(ln) for ln in lines[TRAIN_WARMUP:]), lines
    assert st.step == (TRAIN_STEPS - TRAIN_WARMUP) * TRAIN_UTD
    assert st.buffer.size == TRAIN_STEPS * TRAIN_ENVS, st.buffer.size
    assert lines[-1]["ncon_peak"] <= TRAIN_K, lines[-1]
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    learn_ms = step_ms[TRAIN_WARMUP + 1:]
    log(f"{label} throughput: {lines[-1]['sps']} env-steps/s by the trainer's own "
        f"clock over its {TRAIN_STEPS} steps, {TRAIN_STEPS * TRAIN_ENVS / dt:.1f} with "
        f"its set-up; learning env-batch step (policy step + {TRAIN_UTD} updates) "
        f"{sum(learn_ms) / len(learn_ms):.1f} ms, mean of steps {TRAIN_WARMUP + 2}-"
        f"{TRAIN_STEPS}; all steps (ms, the first with set-up): "
        f"{', '.join(f'{x:.1f}' for x in step_ms)}", recap=True)
    return trainer, st, launches, states


def _same(a, b):
    """Bit-equality of two tensors, or of two dicts of them, or of plain values."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def check_resume(trainer, st, tcfg, sac_cfg, label):
    """Save, restore (bit-equal: networks, buffer, normalizer, counters) and
    one resumed learning step on a new trainer; returns the resumed state."""
    import dataclasses
    import tempfile

    from gym_so100_tpu_torch.agents.train import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        path = trainer.save(st, tmp, st.batch_steps * TRAIN_ENVS)
        st2 = trainer.restore(path)
    saved, restored = trainer.sac.state_dict(st), trainer.sac.state_dict(st2)
    for part in ("actor", "critic", "target_critic", "buffer", "normalizer"):
        for k, v in saved[part].items():
            assert _same(v, restored[part][k]), f"{label} restore: {part}.{k} differs"
    assert _same(saved["log_alpha"], restored["log_alpha"])
    assert (st2.step, st2.batch_steps) == (st.step, st.batch_steps)
    resumed = Trainer(trainer.env.m, dataclasses.replace(
        tcfg, total_steps=(TRAIN_STEPS + 1) * TRAIN_ENVS,
        render_aux=trainer.env.render_aux), sac_cfg, device="cuda")
    lines2 = []
    st3 = resumed.train(seed=SEED, progress=lines2.append, init_state=st2)
    assert [ln["env_steps"] for ln in lines2] == [(TRAIN_STEPS + 1) * TRAIN_ENVS], lines2
    assert st3.step == st.step + TRAIN_UTD and st3.batch_steps == TRAIN_STEPS + 1
    log(f"{label} save/restore: parameters, buffer and normalizer bit-equal; resumed at "
        f"env step {TRAIN_STEPS * TRAIN_ENVS}, one more learning step -> "
        f"{json.dumps(lines2[-1])}", recap=True)
    return st3


def update_ms(sac, st):
    """One SAC update's device time (CUDA events over UPDATE_REPS updates
    alone, on batches sampled beforehand)."""
    import torch

    batches = [st.buffer.sample(sac.cfg.batch_size, st.generator)
               for _ in range(UPDATE_REPS + 1)]
    sac.update(st, batches[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches[1:]:
        sac.update(st, b)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / UPDATE_REPS


def run_training(card):
    """The training phase: Trainer.train on the K = 32 scene at 128 envs
    (warm-up, then learning with utd updates per step), counted; both
    kernels against their plain versions on the trainer env's state at
    touchdown; save, restore (bit-equal) and one resumed step; the time of
    one SAC update.  Returns {kernel name: launches, ms, ...} of the phase."""
    from gym_so100_tpu_torch.agents.sac import SACConfig
    from gym_so100_tpu_torch.agents.train import TrainConfig

    tcfg = TrainConfig(task=TASK, num_envs=TRAIN_ENVS, total_steps=TRAIN_STEPS * TRAIN_ENVS,
                       learning_starts=TRAIN_WARMUP * TRAIN_ENVS, utd=TRAIN_UTD,
                       log_every=1, max_contacts=TRAIN_K)
    trainer, st, launches, states = train_counted(tcfg, SACConfig(), "training",
                                                  keep_states=True)

    # both kernels at K = 32 on the trainer env's first state where at
    # least half the envs have a contact
    env = trainer.env
    at = next((i for i, es in enumerate(states)
               if solver_problem(env, es)[2].con_active.any(0).float().mean() >= 0.5), None)
    assert at is not None, "training: no step with contacts in half the envs"
    log(f"training touchdown (K {TRAIN_K}, {TRAIN_ENVS} envs): after env-batch step "
        f"{at + 1}", recap=True)
    rows = {"hull_sweep": check_hull(env, states[at], timed=True),
            "newton_solve": check_solver(env, states[at], timed=True)}

    st3 = check_resume(trainer, st, tcfg, SACConfig(), "training")
    sac = trainer.sac
    ms = update_ms(sac, st3)
    log(f"SAC update: {ms:.4f} ms per update (features {sac.cfg.features}, "
        f"batch {sac.cfg.batch_size}, CUDA events over {UPDATE_REPS}) on {card}",
        recap=True)
    return {name: dict(launches=launches[name], **rows[name]) for name in rows}


def check_pixel_obs(obs, B):
    import torch

    assert set(obs) == {"pixels", "agent_pos"}, set(obs)
    assert obs["pixels"].shape == (B, PIX_H, PIX_W, 3), obs["pixels"].shape
    assert obs["pixels"].dtype == torch.uint8, obs["pixels"].dtype
    assert obs["agent_pos"].shape == (B, 6) and obs["agent_pos"].dtype == torch.float32
    assert bool(torch.isfinite(obs["agent_pos"]).all()), "agent_pos not finite"


def red_centroids(frames):
    """Centroid (x, y) of each frame's red pixels (B, H, W, 3 uint8) and
    their count, as tests/test_renderer.py finds the cube."""
    import torch

    rgb = frames.int()
    red = (rgb[..., 0] > 1.5 * rgb[..., 1]) & (rgb[..., 0] > 1.5 * rgb[..., 2])
    n = red.sum((1, 2))
    H, W = red.shape[1:]
    ys = torch.arange(H, device=red.device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=red.device, dtype=torch.float32)[None, :]
    cnt = n.clamp(min=1).float()
    return (red * xs).sum((1, 2)) / cnt, (red * ys).sum((1, 2)) / cnt, n


def run_pixel_env(card):
    """The pixel env at the pixel artifact's setting (128 envs, 48x64,
    K = 32), counted: reset, then control steps with seeded random actions,
    half the envs auto-resetting on the first; obs shapes and dtypes, the
    terminal frames, 10 launches of each kernel per control step; the
    card's frames of 16 envs against the same renderer on the CPU; the red
    cube's centroid against its projection; the render and step times.
    Returns {kernel name: launches}."""
    import torch

    from gym_so100_tpu_torch.ops import smooth_lanes, solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    B = TRAIN_ENVS
    env = BatchedEnv(task=TASK, num_envs=B, device="cuda", seed=SEED + 6,
                     max_contacts=TRAIN_K, obs_mode="pixels_agent_pos",
                     obs_height=PIX_H, obs_width=PIX_W)
    r = env.renderer
    log(f"pixel env: {B} envs, {PIX_H}x{PIX_W} top camera, {r.npad_valid} triangles "
        f"({r.faces.shape[0]} padded, chunks of {r.tri_chunk}), K {TRAIN_K}", recap=True)
    gen = torch.Generator(device=env.device).manual_seed(SEED + 7)
    es = env.reset(seed=SEED + 8)
    check_pixel_obs(env.observe(es), B)
    half = B // 2
    t = es.t.clone()
    t[:half] = env.max_episode_steps - 1       # these auto-reset on the first step
    es = es.replace(t=t)
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    step_ms = []
    for i in range(PIX_STEPS):
        actions = torch.rand(B, 6, generator=gen, device=env.device) * 2 - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, obs, reward, term, trunc, info = env.step(es, actions)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_pixel_obs(obs, B)
        check_pixel_obs(info["final_obs"], B)
        assert bool(torch.isfinite(reward).all()), f"pixel step {i}: reward not finite"
        done = term | trunc
        fo = info["final_obs"]["pixels"]
        if i == 0:
            assert bool(done[:half].all()), "pixel env: the first half did not reset"
            moved = (fo.int() - obs["pixels"].int()).abs().amax((1, 2, 3)) > 0
            assert bool(moved[done].all()), "pixel env: a terminal frame equals the reset frame"
            n_done = int(done.sum())
        assert torch.equal(fo[~done], obs["pixels"][~done])
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    log(f"pixel env: {PIX_STEPS} control steps, {n_done} auto-resets on the first, "
        f"terminal frames differ from the reset frames there; launches {launches}",
        recap=True)
    for name, n in launches.items():
        assert n == 10 * PIX_STEPS, f"pixel env: {name} {n} launches, expected {10 * PIX_STEPS}"

    # the card's frames against the same renderer on the CPU
    n = PIX_CPU_ENVS
    ref = r.to("cpu").render_batch(es.physics.index(slice(0, n)).to("cpu"),
                                   PIX_H, PIX_W, "top")
    off = ((obs["pixels"][:n].cpu().int() - ref.int()).abs().amax(-1) > 1)
    share = off.float().mean((1, 2))
    exact = int((obs["pixels"][:n].cpu() == ref).all(-1).all(-1).all(-1).sum())
    log(f"pixel frames, card vs CPU ({n} envs): worst frame {float(share.max()):.5f} of "
        f"pixels more than 1 LSB apart (bound {PIX_FRAME_TOL}), {exact}/{n} frames "
        f"identical", recap=True)
    assert float(share.max()) <= PIX_FRAME_TOL, "pixel frames: card and CPU differ"

    # the red cube lies where the renderer's camera projects it
    cube = smooth_lanes.kinematics(env.m, es.physics).site_xpos[:, env.m.site_id("cube_site")]
    px, py = r.project(es.physics, cube[:, None], PIX_H, PIX_W, "top")
    cx, cy, nred = red_centroids(obs["pixels"])
    seen = nred >= 4
    err = torch.maximum((cx - px[:, 0]).abs(), (cy - py[:, 0]).abs())[seen]
    log(f"pixel cube: visible (>= 4 red px) in {int(seen.sum())}/{B} envs, centroid vs "
        f"projection max {float(err.max()):.3f} px (bound 4)", recap=True)
    # at 48x64 the cube covers 1-6 pixels: about half the envs show 4
    assert int(seen.sum()) >= B // 8, "pixel cube: visible in too few envs"
    assert float(err.max()) < 4, "pixel cube: centroid away from its projection"

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    render = cuda_ms(lambda: r.render_batch(es.physics, PIX_H, PIX_W, "top"), RENDER_REPS)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    step = sum(step_ms[1:]) / len(step_ms[1:])
    log(f"pixel render: {render:.4f} ms per batched {B}-env render (CUDA events over "
        f"{RENDER_REPS}, kinematics included), {peak:.1f} MiB peak working memory; "
        f"pixel control step {step:.1f} ms (host clock, mean of steps 2-{PIX_STEPS}; "
        f"step 1 with its reset render {step_ms[0]:.1f} ms), render share "
        f"{render / step:.4f}; on {card}", recap=True)
    return launches


def run_pixel_training(card):
    """Pixel training at the artifact's setting (48x64, 128 envs, utd 8,
    K = 32), full-width SAC (256, 256), batch 256, buffer 50,000: counted,
    the uint8 buffer checked, save, restore (bit-equal) and one resumed
    step, one pixel SAC update timed.  Returns {kernel name: launches}."""
    import torch

    from gym_so100_tpu_torch.agents.sac import SACConfig
    from gym_so100_tpu_torch.agents.train import TrainConfig

    tcfg = TrainConfig(task=TASK, num_envs=TRAIN_ENVS, total_steps=TRAIN_STEPS * TRAIN_ENVS,
                       learning_starts=TRAIN_WARMUP * TRAIN_ENVS, utd=TRAIN_UTD,
                       log_every=1, max_contacts=TRAIN_K, obs="pixels_agent_pos",
                       obs_height=PIX_H, obs_width=PIX_W)
    sac_cfg = SACConfig(obs_dim=6, pixels=(PIX_H, PIX_W))
    trainer, st, launches, _ = train_counted(tcfg, sac_cfg, "pixel training")
    pix = st.buffer.obs["pixels"]
    assert pix.dtype == torch.uint8 and pix.shape == (sac_cfg.buffer_size, PIX_H, PIX_W, 3)
    assert st.buffer.next_obs["pixels"].dtype == torch.uint8
    assert int(pix[:st.buffer.size].amax()) > 0, "pixel training: empty frames stored"
    st3 = check_resume(trainer, st, tcfg, sac_cfg, "pixel training")
    ms = update_ms(trainer.sac, st3)
    log(f"pixel SAC update: {ms:.4f} ms per update (NatureCNN {PIX_H}x{PIX_W} + "
        f"features {sac_cfg.features}, batch {sac_cfg.batch_size}, CUDA events over "
        f"{UPDATE_REPS}) on {card}", recap=True)
    return launches


def run_her(card):
    """HER at the artifact's configuration, cut to HER_STEPS env-batch steps
    of HER_EP_STEPS-step episodes, counted; save, restore (bit-equal) and one
    resumed step; the time of one HER update; both kernels against their
    plain versions on the HER env's state at touchdown, timed.  Returns
    {kernel name: launches, check and time fields}."""
    import dataclasses
    import math
    import tempfile

    import torch

    from gym_so100_tpu_torch.agents.sac import SACConfig
    from gym_so100_tpu_torch.agents.train_her import GOAL_DIM, HERConfig, HERTrainer
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    cfg = HERConfig(num_envs=HER_ENVS, total_steps=HER_STEPS * HER_ENVS,
                    learning_starts=HER_WARMUP * HER_ENVS, her_episodes=HER_EPISODES,
                    her_ratio=0.8, utd=HER_UTD, curriculum_steps=1 << 30,
                    goal_min_dist=HER_MIN_DIST, log_every=1, max_contacts=TRAIN_K,
                    max_episode_steps=HER_EP_STEPS)
    sac_cfg = SACConfig(obs_dim=15 + GOAL_DIM, act_dim=6, lr=1e-4, buffer_size=1,
                        batch_size=256)
    log(f"HER: so100_cube_to_bin, {HER_ENVS} envs, K {TRAIN_K}, utd {HER_UTD}, batch "
        f"{sac_cfg.batch_size}, {HER_EPISODES} episodes, ratio {cfg.her_ratio}, near-cube "
        f"goals, goal_min_dist {HER_MIN_DIST}, SAC {sac_cfg.features}; cut to "
        f"{HER_STEPS} env-batch steps ({HER_WARMUP} warm-up) of {HER_EP_STEPS}-step "
        f"episodes (300 in the artifact)", recap=True)
    trainer = HERTrainer(None, cfg, sac_cfg, device="cuda")
    lines, stamps = [], []

    def progress(line):
        stamps.append(time.perf_counter())
        lines.append(line)

    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts = trainer.train(seed=SEED, progress=progress)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    her = ts.her
    done = sum(ln["episodes_done"] for ln in lines)
    log(f"HER: {HER_STEPS} env-batch steps, {ts.sac.step} SAC updates, {done} episodes "
        f"ended ({done - 2 * HER_ENVS} beyond two per lane: successes, and the episodes "
        f"that restarted lanes then ended), "
        f"buffer cursor {her.ptr}, {her.n_eps} stored, launches {launches}, last line "
        f"{json.dumps(lines[-1])}", recap=True)
    for name, n in launches.items():
        assert n == 10 * HER_STEPS, f"HER: {name} {n} launches, expected {10 * HER_STEPS}"
    assert [ln["env_steps"] for ln in lines] == [(i + 1) * HER_ENVS for i in range(HER_STEPS)]
    for ln in lines:
        assert all(math.isfinite(v) for v in ln.values()), f"HER: not finite: {ln}"
    assert her.n_eps == HER_EPISODES and her.ptr == done >= 2 * HER_ENVS, (her.ptr, done)
    assert ts.sac.step == (HER_STEPS - HER_WARMUP) * HER_UTD, ts.sac.step
    lens = her.ep_len
    assert bool(((lens >= 1) & (lens <= HER_EP_STEPS)).all()), "HER: episode lengths"
    for name in ("obs", "next_obs", "agoal", "dgoal"):
        assert bool(torch.isfinite(getattr(her, name)).all()), f"HER buffer: {name}"
    assert lines[-1]["ncon_peak"] <= TRAIN_K, lines[-1]
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    learn_ms = step_ms[HER_WARMUP + 1:]
    log(f"HER throughput: {lines[-1]['sps']} env-steps/s by the trainer's own clock over "
        f"its {HER_STEPS} steps, {HER_STEPS * HER_ENVS / dt:.1f} with its set-up; learning "
        f"env-batch step (policy step + {HER_UTD} HER updates) "
        f"{sum(learn_ms) / len(learn_ms):.1f} ms, mean of steps {HER_WARMUP + 2}-{HER_STEPS}; "
        f"all steps (ms, the first with set-up): {', '.join(f'{x:.1f}' for x in step_ms)}; "
        f"on {card}", recap=True)

    # save -> restore, bit-equal; one resumed step continues the counter
    with tempfile.TemporaryDirectory(prefix="chip_smoke_her_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        path = trainer.save(ts, tmp, ts.genv.total)
        ts2 = trainer.restore(path)
    assert _same(trainer.state_dict(ts), trainer.state_dict(ts2)), "HER restore differs"
    resumed = HERTrainer(trainer.m, dataclasses.replace(
        cfg, total_steps=(HER_STEPS + 1) * HER_ENVS), sac_cfg, device="cuda")
    lines2 = []
    ts3 = resumed.train(seed=SEED, progress=lines2.append, init_state=ts2)
    assert [ln["env_steps"] for ln in lines2] == [(HER_STEPS + 1) * HER_ENVS], lines2
    assert ts3.sac.step == ts.sac.step + HER_UTD, "HER: the resumed step took no updates"
    log(f"HER save/restore: whole state bit-equal; resumed at env step "
        f"{HER_STEPS * HER_ENVS}, one learning step (no warm-up) -> "
        f"{json.dumps(lines2[-1])}", recap=True)

    # one HER update: sample + SAC update, by CUDA events
    sac, st = resumed.sac, ts3.sac

    def her_update():
        batch = ts3.her.sample(sac_cfg.batch_size, st.generator, cfg.her_ratio,
                               cfg.distance_threshold)
        sac.update(st, batch)

    ms = cuda_ms(her_update, UPDATE_REPS)
    log(f"HER update: {ms:.4f} ms per update (HER sample + SAC update, features "
        f"{sac_cfg.features}, batch {sac_cfg.batch_size}, CUDA events over {UPDATE_REPS}) "
        f"on {card}", recap=True)

    # both kernels at the path's shapes (B = 256, K = 32) on the HER env's
    # own state, run on to the cube's touchdown: the cut episodes end
    # before the cube lands, so the counted run saw no contact
    env = resumed.env
    gen = torch.Generator(device=env.device).manual_seed(SEED + 11)
    es, steps = ts3.genv.es, 0
    while solver_problem(env, es)[2].con_active.any(0).float().mean() < 0.5:
        assert steps < TOUCHDOWN_MAX, "HER: no touchdown: too few envs have a contact"
        es = advance(env, es, 1, gen)
        steps += 1
    log(f"HER touchdown (K {TRAIN_K}, {HER_ENVS} envs): {steps} control steps after the "
        f"resumed step", recap=True)
    rows = {"hull_sweep": check_hull(env, es, timed=True),
            "newton_solve": check_solver(env, es, timed=True, floor_samples=FLOOR_SAMPLES)}
    return {name: dict(launches=launches[name], **rows[name]) for name in rows}


def run_ee(card):
    """The Cartesian env at 1024 envs, counted: moves along per-env unit
    directions, then holds; the JAX tracking criteria on the first lanes;
    both kernels against their plain versions on the state after the moves
    (the weld's equality rows in the solve), timed; an EE control step
    timed.  Returns {kernel: dict(launches, check and time fields, neq)}."""
    import numpy as np
    import torch

    from gym_so100_tpu_torch.envs.ee_env import CartesianBatchedEnv
    from gym_so100_tpu_torch.ops import smooth_lanes, solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    B = EE_ENVS
    env = CartesianBatchedEnv(num_envs=B, device="cuda", seed=SEED + 9,
                              max_contacts=TRAIN_K)
    m = env.m
    tb = hull_lanes.hull_tables(m)
    log(f"EE: CartesianBatchedEnv, {B} envs, K {TRAIN_K}, gained weld (solimp "
        f"{m.eq_solimp[0, :2].tolist()}, solref {m.eq_solref[0].tolist()}), "
        f"{env.orientation_mode} mode; model nq {m.nq} nv {m.nv}, pairs "
        f"{len(m.pairs.box_box)} box-box / {len(m.pairs.hull_box)} hull-box / "
        f"{len(m.pairs.hull_hull)} hull-hull; hull tables G {tb.G} geoms, ND "
        f"{tb.D.shape[0]} directions, P {tb.P} pairs", recap=True)
    rng = np.random.RandomState(0)
    dirs = rng.uniform(-1, 1, (B, 3))
    dirs[:, 2] = np.abs(dirs[:, 2])              # stay above the table
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs_t = torch.tensor(dirs, dtype=torch.float32, device=env.device)
    move = torch.cat([dirs_t * 0.5, torch.zeros(B, 1, device=env.device)], 1)
    hold = torch.zeros(B, 4, device=env.device)

    es = env.reset(seed=SEED + 10)
    ee_site = env.ids.ee_site
    start = es.physics.mocap_pos[:, 0].clone()
    ee0 = smooth_lanes.kinematics(m, es.physics).site_xpos[:, ee_site].clone()
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    step_ms = []
    moved_state = None
    for i in range(EE_MOVE_STEPS + EE_HOLD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, obs, reward, term, trunc, info = env.step(es, move if i < EE_MOVE_STEPS else hold)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert obs.shape == (B, 15) and bool(torch.isfinite(obs).all()), f"EE step {i}: obs"
        assert bool(torch.isfinite(info["ee_err"]).all()), f"EE step {i}: ee_err"
        if i == EE_MOVE_STEPS - 1:
            moved_state = es
    n_steps = EE_MOVE_STEPS + EE_HOLD_STEPS
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    for name, n in launches.items():
        assert n == 10 * n_steps, f"EE: {name} {n} launches, expected {10 * n_steps}"

    target = es.physics.mocap_pos[:, 0]
    moved = (target - start).norm(dim=1)
    assert float((moved - 0.05).abs().max()) <= 1e-5, "EE: the target did not move 5 cm"
    ee = smooth_lanes.kinematics(m, es.physics).site_xpos[:, ee_site]
    err = (ee - target).norm(dim=1)
    along = ((ee - ee0) * dirs_t).sum(1)
    n = EE_TRACKED
    q = torch.quantile(err, torch.tensor([0.5, 0.95], device=err.device)).tolist()
    log(f"EE: {EE_MOVE_STEPS} move + {EE_HOLD_STEPS} hold control steps, launches "
        f"{launches}; target moved 5 cm (max dev {float((moved - 0.05).abs().max()):.2e}); "
        f"ee_err over all {B} lanes: min {float(err.min()):.4f} median {q[0]:.4f} p95 "
        f"{q[1]:.4f} max {float(err.max()):.4f} m, {int((err < 0.025).sum())} lanes within "
        f"2.5 cm, {int((along > 0.02).sum())} moved > 2 cm along their direction; first "
        f"{n}: err {[round(x, 4) for x in err[:n].tolist()]}, along "
        f"{[round(x, 4) for x in along[:n].tolist()]}", recap=True)
    assert bool((err[:n] < 0.025).all()), f"EE: first {n} lanes off their targets"
    assert bool((along[:n] > 0.02).all()), f"EE: first {n} lanes did not follow"

    neq = solver_problem(env, moved_state)[2].neq
    log(f"EE kernel checks on the state after the moves: neq {neq} equality rows "
        f"(the 6-row weld) in the Newton solve", recap=True)
    assert neq == 6, neq
    rows = {"hull_sweep": check_hull(env, moved_state, timed=True),
            "newton_solve": check_solver(env, moved_state, timed=True,
                                         floor_samples=FLOOR_SAMPLES)}
    step = sum(step_ms[1:]) / len(step_ms[1:])
    log(f"EE control step: {step:.1f} ms (host clock, mean of steps 2-{n_steps}; the first "
        f"{step_ms[0]:.1f} ms), {B / step * 1e3:.1f} env-steps/s; kernels "
        f"{rows['hull_sweep']['ms']:.4f} + {rows['newton_solve']['ms']:.4f} ms per launch "
        f"x 10 = {10 * (rows['hull_sweep']['ms'] + rows['newton_solve']['ms']) / step:.4f} "
        f"of a control step; on {card}", recap=True)
    return {name: dict(launches=launches[name], neq=neq, **rows[name]) for name in rows}


def _single_obs64(env):
    """The state obs of a single env in float64 (box, bin, ee, arm qpos),
    from its last position stage."""
    import torch

    from gym_so100_tpu_torch.envs import core

    u = env.unwrapped
    o = core.observations(u._m, u.data, u._es.physics, u._ids)
    return torch.cat([o["box_position"], o["bin_position"], o["ee_position"],
                      o["qpos"]]).cpu()


def _single_run(env, actions, seed, moved=False):
    """Reset `env` with `seed` (its start qpos moved up one ulp in a seeded
    half of its entries when `moved`), take the control steps `actions`;
    returns (state obs per step (float64, CPU), host ms per step, active
    contacts per step, whether a ccd manifold pair was among them, the last
    step's 5-tuple)."""
    import numpy as np
    import torch

    env.reset(seed=seed)
    u = env.unwrapped
    if moved:
        q = u._es.physics.qpos
        mask = torch.from_numpy(np.random.RandomState(seed).rand(q.shape[0]) < 0.5).to(q.device)
        q = torch.where(mask, torch.nextafter(q, torch.full_like(q, np.inf)), q)
        u._es = u._es.replace(physics=u._es.physics.replace(qpos=q))
    ccd = {(p[0], p[1]) for p in u._m.pairs.ccd}
    sync = torch.cuda.synchronize if u.device.type == "cuda" else (lambda: None)
    obs, ms, ncon, manifold = [], [], [], False
    for a in actions:
        sync()
        t0 = time.perf_counter()
        out = env.step(a)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        con = u.data.contact
        act = con.active.cpu()
        ncon.append(int(act.sum()))
        pairs = zip(con.geom1.cpu()[act].tolist(), con.geom2.cpu()[act].tolist())
        manifold |= any(p in ccd for p in pairs)
        obs.append(_single_obs64(env))
    return torch.stack(obs), ms, ncon, manifold, out


def run_single_env(card):
    """The single-env Gymnasium-API path on the card, counted: the
    registered SO100TouchCube-v0 in float64 (640x480 pixels, ccd manifolds,
    K = 32) through the cube's landing, held to the same steps on the CPU
    (the floor rule: the larger of SINGLE_TOL and twice the spread of the
    CPU run against itself with its start moved one ulp); the float32 env; SO100GoalEnv.  Neither
    kernel launches.  Returns the phase's numbers."""
    import numpy as np
    import torch

    from gym_so100_tpu_torch.envs.goal_env import SO100GoalEnv
    from gym_so100_tpu_torch.envs.gym_env import SO100Env
    from gym_so100_tpu_torch.envs.registration import make
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    actions = list(np.random.RandomState(SEED + 20).uniform(
        -1, 1, (SINGLE_STEPS, 6)).astype(np.float32))

    env = make(SINGLE_ID, dtype=torch.float64)
    u = env.unwrapped
    m = u._m
    assert u.device.type == "cuda" and m.dtype == torch.float64
    assert (u.obs_type, u.observation_height, u.observation_width) == (
        "so100_pixels_agent_pos", 480, 640)
    log(f"single env: {SINGLE_ID}, float64, {u.observation_height}x{u.observation_width} "
        f"pixels + agent_pos, K {m.max_contacts}, {len(m.pairs.ccd)} ccd manifold pairs, "
        f"{len(m.pairs.box_box)} box-box pairs", recap=True)
    obs0, _ = env.reset(seed=SEED)
    assert obs0["pixels"].shape == (480, 640, 3) and obs0["pixels"].dtype == np.uint8
    obs64, ms64, ncon, manifold, (last, *_) = _single_run(env, actions, SEED)
    assert last["pixels"].shape == (480, 640, 3) and np.isfinite(last["agent_pos"]).all()
    assert bool(torch.isfinite(obs64).all()), "single env: obs not finite"
    assert max(ncon) > 0 and manifold, f"single env: no manifold contact ({ncon})"

    # the same steps on the CPU, and the CPU against itself moved one ulp
    cpu = make(SINGLE_ID, dtype=torch.float64, device="cpu", obs_type="so100_state")
    t0 = time.perf_counter()
    obs_cpu, ms_cpu, ncon_cpu, _, _ = _single_run(cpu, actions, SEED)
    obs_mov = _single_run(cpu, actions, SEED, moved=True)[0]
    cpu_s = time.perf_counter() - t0
    dev = float((obs64 - obs_cpu).abs().max())
    spread = float((obs_mov - obs_cpu).abs().max())
    bound = max(SINGLE_TOL, 2 * spread)
    log(f"single env vs the CPU: max |obs - obs_cpu| {dev:.3e} over {SINGLE_STEPS} steps, "
        f"bound {bound:.3e} (the larger of {SINGLE_TOL:g} and twice the CPU run's one-ulp "
        f"spread {spread:.3e}); active contacts per step card {ncon}, CPU {ncon_cpu}",
        recap=True)
    assert ncon == ncon_cpu, "single env: the contact counts differ from the CPU's"
    assert dev <= bound, f"single env: {dev} from the CPU, bound {bound}"

    # one 640x480 render, by CUDA events
    render_ms = cuda_ms(lambda: u._get_renderer().render(u._es.physics, 480, 640),
                        SINGLE_RENDER_REPS)

    env32 = SO100Env(task="so100_touch_cube", obs_type="so100_state")
    assert env32._m.dtype == torch.float32 and env32.device.type == "cuda"
    obs32, ms32, ncon32, _, _ = _single_run(env32, actions, SEED)
    assert bool(torch.isfinite(obs32).all()), "single env float32: obs not finite"

    goal = SO100GoalEnv()
    gobs, _ = goal.reset(seed=SEED)
    n_obs = 480 * 640 * 3 + 6
    for a in actions[:GOAL_STEPS]:
        gobs, reward, success, trunc, info = goal.step(a)
        assert gobs["observation"].shape == (n_obs,) and reward in (0.0, -1.0)
        assert np.isfinite(gobs["observation"]).all() and np.isfinite(gobs["achieved_goal"]).all()

    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    assert launches == {"hull_sweep": 0, "newton_solve": 0}, f"single env launched {launches}"
    med = lambda v: float(np.median(v[1:]))
    out = dict(
        steps=SINGLE_STEPS, step_ms_f64=med(ms64), first_step_ms_f64=ms64[0],
        step_ms_f32=med(ms32), first_step_ms_f32=ms32[0], step_ms_cpu_f64=med(ms_cpu),
        render_ms_640x480=render_ms, max_abs_dev_cpu=dev, cpu_spread=spread, bound=bound,
        ncon=ncon, ncon_f32=ncon32, launches=launches, cpu_s=cpu_s, card=card)
    log(f"single env: ms per control step (median of steps 2-{SINGLE_STEPS}, host clock): "
        f"float64 {out['step_ms_f64']:.1f} (first {ms64[0]:.1f}; the CPU "
        f"{out['step_ms_cpu_f64']:.1f}), "
        f"float32 {out['step_ms_f32']:.1f} (first {ms32[0]:.1f}); a 640x480 render "
        f"{render_ms:.2f} ms (CUDA events over {SINGLE_RENDER_REPS}); kernel launches "
        f"{launches}; on {card}", recap=True)
    return out


def _frac_in_contact(env, es):
    return float(solver_problem(env, es)[2].con_active.any(0).float().mean())


def _dist_rank(rank, world, port, backend, out_dir, num_envs):
    """One rank of the multi-GPU phase (started by torch.multiprocessing):
    the process group, the trainer on its shard, counted; both kernels
    against their plain versions on its shard at touchdown; its results in
    out_dir/rank<rank>.json and its warm-up transitions in .pt."""
    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.agents.sac import SACConfig
    from gym_so100_tpu_torch.agents.train import TrainConfig, Trainer
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert dist.init_distributed(f"localhost:{port}", world, rank, device="cuda",
                                 backend=backend)
    group = dist.env_mesh()
    kernels.library()
    assert kernels.build_info.get("cached"), "a rank rebuilt the kernels"
    device = dist.rank_device("cuda")
    tcfg = TrainConfig(task=TASK, num_envs=num_envs, total_steps=DIST_STEPS * num_envs,
                       learning_starts=DIST_WARMUP * num_envs, utd=TRAIN_UTD, log_every=1,
                       max_contacts=TRAIN_K)
    trainer = Trainer(None, tcfg, SACConfig(), device=device, group=group)
    env = trainer.env
    lines, stamps = [], []

    def progress(line):      # rank 0 only; a log line reads the device
        stamps.append(time.perf_counter())
        lines.append(line)

    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = trainer.train(seed=SEED, progress=progress)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    for name, n in launches.items():
        assert n == 10 * DIST_STEPS, f"rank {rank}: {name} {n} launches"
    assert st.step == (DIST_STEPS - DIST_WARMUP) * TRAIN_UTD
    assert st.buffer.size == DIST_STEPS * num_envs
    flat = torch.cat([p.detach().reshape(-1) for p in (
        *st.actor.parameters(), *st.critic.parameters(), *st.target_critic.parameters(),
        st.log_alpha.reshape(1))])
    every = dist.all_gather_env(flat[None], group)
    params_equal = all(torch.equal(every[0], every[r]) for r in range(world))
    assert params_equal, f"rank {rank}: parameters differ across ranks"
    update = _sharded_update(trainer.sac, st, group)
    # both kernels on this rank's shard at touchdown: every rank steps on
    # (whole-batch actions, its rows) until each has half its envs in contact
    es = trainer.env_state
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    steps = 0
    while dist.any_across(torch.tensor(_frac_in_contact(env, es) < 0.5, device=device),
                          group):
        assert steps < TOUCHDOWN_MAX, f"rank {rank}: no touchdown"
        acts = torch.rand(num_envs, 6, generator=gen, device=device) * 2 - 1
        es = env.step(es, acts[env.rows])[0]
        steps += 1
    rows = {"hull_sweep": check_hull(env, es, timed=True),
            "newton_solve": check_solver(env, es, timed=True)}
    n = DIST_WARMUP * num_envs
    torch.save({k: getattr(st.buffer, k)[:n].cpu() for k in ("obs", "act", "rew", "next_obs",
                                                             "done")},
               Path(out_dir) / f"rank{rank}.pt")
    out = dict(rank=rank, world=world, backend=torch.distributed.get_backend(group),
               device=str(device), shard=env.num_envs, launches=launches,
               env_steps_per_s=DIST_STEPS * num_envs / dt, seconds=dt,
               # after the first env-batch step, which holds the set-up
               steady_env_steps_per_s=(len(stamps) - 1) * num_envs
               / (stamps[-1] - stamps[0]) if len(stamps) > 1 else None,
               touchdown_steps=steps, params_equal=params_equal, update=update,
               lines=lines, kernels={k: {f: v[f] for f in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                   for k, v in rows.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _sharded_update(sac, st, group):
    """SAC.update(group=...) on this rank's rows of a whole-batch sample
    against the full update on the whole batch, each on a copy of the
    trained learner (the same draws: the copies start from one generator
    state), and the update without the average as a planted fault; then
    both timed over DIST_UPDATE_REPS updates by the host clock (the
    collectives included).  Returns the deviations and times."""
    import torch

    from gym_so100_tpu_torch.parallel import dist

    saved = sac.state_dict(st)
    n = sac.cfg.batch_size
    rows = dist.env_rows(n, group)

    def params(s):
        return torch.cat([p.detach().reshape(-1) for p in (
            *s.actor.parameters(), *s.critic.parameters(), *s.target_critic.parameters(),
            s.log_alpha.reshape(1))])

    def sharded(s, average=True):
        batch = dist.shard_env(s.buffer.sample(n, s.generator), group)
        if average:
            return sac.update(s, batch, group=group)
        return sac.update(s, batch, noise=[sac._noise(s, n)[rows] for _ in range(2)])

    full = sac.load_state_dict(saved)
    full, m_full = sac.update(full, full.buffer.sample(n, full.generator))
    part, m_part = sharded(sac.load_state_dict(saved))
    fault = sharded(sac.load_state_dict(saved), average=False)[0]
    dev = float((params(part) - params(full)).abs().max())
    fault_dev = float((params(fault) - params(full)).abs().max())
    loss_dev = max(abs(float(m_part[k]) / float(m_full[k]) - 1)
                   for k in ("critic_loss", "actor_loss", "entropy"))
    every = dist.all_gather_env(params(part)[None], group)
    assert all(torch.equal(every[0], e) for e in every), "sharded update: ranks differ"
    assert dev <= DIST_UPDATE_TOL and loss_dev <= DIST_LOSS_RTOL, (
        f"sharded update: parameters {dev}, losses {loss_dev} from the full update")
    assert dist.world(group)[1] == 1 or fault_dev > DIST_UPDATE_TOL, fault_dev
    ms = {}
    for tag, s, shard in (("full", full, False), ("sharded", part, True)):
        batches = [s.buffer.sample(n, s.generator) for _ in range(DIST_UPDATE_REPS)]
        if shard:
            batches = [dist.shard_env(b, group) for b in batches]
        torch.cuda.synchronize()
        torch.distributed.barrier(group)
        t0 = time.perf_counter()
        for b in batches:
            sac.update(s, b, group=group if shard else None)
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - t0) * 1e3 / DIST_UPDATE_REPS
    return dict(batch=n, rows=n // dist.world(group)[1], max_abs_dev=dev,
                loss_rel_dev=loss_dev, fault_max_abs_dev=fault_dev, full_ms=ms["full"],
                sharded_ms=ms["sharded"])


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_dist(card):
    """The multi-GPU phase: DIST_RANKS ranks over gloo on the one card, then
    one rank over NCCL, each a process of its own, at DIST_ENVS envs of the
    training configuration.  Returns {kernel: the dist row}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        runs = {}
        for tag, world, backend in (("gloo", DIST_RANKS, "gloo"), ("nccl", 1, None)):
            out = Path(tmp) / tag
            out.mkdir()
            t0 = time.perf_counter()
            mp.start_processes(_dist_rank, args=(world, _free_port(), backend, str(out),
                                                 DIST_ENVS),
                               nprocs=world, join=True, start_method="spawn")
            runs[tag] = dict(
                wall=time.perf_counter() - t0,
                ranks=[json.loads((out / f"rank{r}.json").read_text()) for r in range(world)],
                warm=[torch.load(out / f"rank{r}.pt") for r in range(world)])
        gloo, nccl = runs["gloo"], runs["nccl"]
        assert [r["backend"] for r in gloo["ranks"]] == ["gloo"] * DIST_RANKS
        assert nccl["ranks"][0]["backend"] == "nccl"
        ref = nccl["warm"][0]
        devs = {}
        for r, warm in enumerate(gloo["warm"]):
            assert torch.equal(warm["act"], ref["act"]), f"rank {r}: warm-up actions differ"
            assert torch.equal(warm["done"], ref["done"]), f"rank {r}: done flags differ"
            devs[r] = max(float((warm[k] - ref[k]).abs().max())
                          for k in ("obs", "next_obs", "rew"))
        assert torch.equal(gloo["warm"][0]["obs"], gloo["warm"][1]["obs"])
    for tag, run in runs.items():
        for rk in run["ranks"]:
            log(f"dist {tag}: rank {rk['rank']}/{rk['world']} on {rk['device']}, "
                f"{rk['shard']} of {DIST_ENVS} envs, launches {rk['launches']} "
                f"({DIST_STEPS} env-batch steps), parameters bit-equal across ranks "
                f"{rk['params_equal']}, touchdown {rk['touchdown_steps']} steps after the "
                f"run; kernels on its shard: " + ", ".join(
                    f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                    f"{v['bound_ms']:.4f}, max abs err {v['max_abs_err']:.3g})"
                    for k, v in rk["kernels"].items()), recap=True)
        r0 = run["ranks"][0]
        log(f"dist {tag}: SAC.update(group=...) on each rank's {r0['update']['rows']} of "
            f"{r0['update']['batch']} rows against the full update: parameters max |difference| "
            + ", ".join(f"{rk['update']['max_abs_dev']:.3g}" for rk in run["ranks"])
            + ", losses relative "
            + ", ".join(f"{rk['update']['loss_rel_dev']:.3g}" for rk in run["ranks"])
            + f" (bounds {DIST_UPDATE_TOL:g}, {DIST_LOSS_RTOL:g}), without the average "
            f"(planted fault) "
            + ", ".join(f"{rk['update']['fault_max_abs_dev']:.3g}" for rk in run["ranks"])
            + "; ranks bit-equal; ms per update (host clock, "
            f"{DIST_UPDATE_REPS}): full " + ", ".join(
                f"{rk['update']['full_ms']:.3f}" for rk in run["ranks"]) + ", sharded "
            + ", ".join(f"{rk['update']['sharded_ms']:.3f}" for rk in run["ranks"])
            + f"; on {card}", recap=True)
        log(f"dist {tag}: {r0['steady_env_steps_per_s']:.1f} env-steps/s over "
            f"{len(run['ranks'])} rank(s) ({DIST_ENVS} envs, K {TRAIN_K}, utd {TRAIN_UTD}; "
            f"rank 0's clock over env-batch steps 2-{DIST_STEPS}), "
            f"{r0['env_steps_per_s']:.1f} over all {DIST_STEPS} with the first's set-up; "
            f"phase part {run['wall']:.1f} s with start-up; on {card}", recap=True)
    log(f"dist: the {DIST_RANKS} gloo ranks' warm-up transitions against the one-rank "
        f"NCCL run's ({DIST_ENVS} envs): actions and done flags equal, max |obs, next_obs, "
        f"rew difference| per rank {devs} (bound {DIST_OBS_TOL}); the ranks' gathered "
        f"buffers equal each other", recap=True)
    assert max(devs.values()) <= DIST_OBS_TOL, devs
    return {name: dict(
        ranks=DIST_RANKS, backend="gloo", shard=DIST_ENVS // DIST_RANKS,
        launches=[rk["launches"][name] for rk in gloo["ranks"]],
        ms=[rk["kernels"][name]["ms"] for rk in gloo["ranks"]],
        plain_ms=[rk["kernels"][name]["plain_ms"] for rk in gloo["ranks"]],
        bound_ms=[rk["kernels"][name]["bound_ms"] for rk in gloo["ranks"]],
        max_abs_err=[rk["kernels"][name]["max_abs_err"] for rk in gloo["ranks"]],
        env_steps_per_s=gloo["ranks"][0]["steady_env_steps_per_s"],
        update_ms={tag: {k: [rk["update"][k] for rk in run["ranks"]]
                         for k in ("full_ms", "sharded_ms")} for tag, run in runs.items()},
        nccl_world1=dict(launches=nccl["ranks"][0]["launches"][name],
                         ms=nccl["ranks"][0]["kernels"][name]["ms"],
                         env_steps_per_s=nccl["ranks"][0]["steady_env_steps_per_s"]))
        for name in ("hull_sweep", "newton_solve")}


def _panda_run(m, aux, hold=PANDA_HOLD, move=PANDA_MOVE, ulp=False):
    """The Panda scene from "home" (with `ulp`, its nonzero qpos moved one
    ulp up) with the mocap target on the ee, then `hold` control steps,
    then the target 3 cm along +x for `move` steps.  Returns (qpos per
    step (float64, CPU), ee x after the hold (None without a move) and at
    the end, finger gap, ms per step)."""
    import torch

    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.ops import smooth

    kq, kc = aux["keyframes"]["home"]
    ee = m.site_id("ee_site")
    kin = lambda s: smooth.kinematics(m, s).site_xpos[ee]
    s = fwd.make_state(m, qpos=kq, ctrl=kc)
    if ulp:
        s = s.replace(qpos=torch.where(s.qpos != 0, torch.nextafter(
            s.qpos, torch.full_like(s.qpos, float("inf"))), s.qpos))
    s = s.replace(mocap_pos=kin(s)[None].clone())
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)
    qs, ms, held = [], [], None
    for i in range(hold + move):
        if i == hold:
            held = float(kin(s)[0])
            s = s.replace(mocap_pos=s.mocap_pos + torch.tensor(
                [[0.03, 0.0, 0.0]], dtype=s.mocap_pos.dtype, device=m.device))
        sync()
        t0 = time.perf_counter()
        s = fwd.n_steps(m, s, 10)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        qs.append(s.qpos.double().cpu())
    q1 = s.qpos[m.jnt_qposadr[m.joint_id("finger_joint1")]]
    q2 = s.qpos[m.jnt_qposadr[m.joint_id("finger_joint2")]]
    return torch.stack(qs), held, float(kin(s)[0]), float((q1 - q2).abs()), ms


def run_panda(card):
    """The Panda EE scene (float32, K = PANDA_K) on the card: finite, the
    fingers coupled, the ee following the target's move along +x; held to
    the same steps on the CPU (qpos within PANDA_TOL, the ee's move within
    1 mm).  The bound's witnesses: it lies above twice the card's own
    spread under a one-ulp move of the start and below the card's run with
    a planted fault (the finger-coupling equality dropped, over the hold
    steps); and the first PANDA64_STEPS in float64 hold the card to the
    CPU as phase 9 does.  Neither kernel launches: the single-env engine
    runs neither (the batched Panda step does: run_panda_batched)."""
    import dataclasses

    import numpy as np
    import torch

    from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    m, aux = build_model(PANDA_XML, max_contacts=PANDA_K, device="cuda")
    log(f"Panda: nq {m.nq} nv {m.nv} nu {m.nu}, {m.ngeom} geoms, {len(m.eq_site1)} weld and "
        f"{len(m.eq_jnt_q1)} joint equality, K {PANDA_K}, float32; {PANDA_HOLD} hold + "
        f"{PANDA_MOVE} move control steps", recap=True)
    qs, held, end, gap, ms = _panda_run(m, aux)
    assert bool(torch.isfinite(qs).all()), "Panda: qpos not finite"
    t0 = time.perf_counter()
    q_cpu, held_cpu, end_cpu, _, ms_cpu = _panda_run(
        *build_model(PANDA_XML, max_contacts=PANDA_K, device="cpu"))
    cpu_s = time.perf_counter() - t0
    dev = float((qs - q_cpu).abs().max())
    dx_dev = abs((end - held) - (end_cpu - held_cpu))
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    med = lambda v: float(np.median(v[1:]))
    log(f"Panda: ee moved {end - held:+.4f} m along x after the 3 cm move (CPU "
        f"{end_cpu - held_cpu:+.4f}), finger gap |q1 - q2| {gap:.2e} (bound 5e-3); card vs "
        f"CPU max |qpos difference| {dev:.3e} (bound {PANDA_TOL:g}); ms per control step "
        f"{med(ms):.1f} (card), {med(ms_cpu):.1f} (CPU), median of steps 2-{len(ms)}; CPU "
        f"run {cpu_s:.1f} s; launches {launches}; on {card}", recap=True)
    assert gap < 5e-3, "Panda: the fingers decoupled"
    assert end - held > 0.015, "Panda: the ee did not follow the target along +x"
    assert dev <= PANDA_TOL and dx_dev <= 1e-3, f"Panda: {dev}, {dx_dev} from the CPU"
    assert launches == {"hull_sweep": 0, "newton_solve": 0}, launches

    # the witnesses of PANDA_TOL: the card against itself, and a planted
    # fault in a Panda-only part, the finger-coupling equality gone
    spread = float((_panda_run(m, aux, ulp=True)[0] - qs).abs().max())
    faulty = dataclasses.replace(m, eq_jnt_q1=(), eq_jnt_q2=(), eq_jnt_v1=(), eq_jnt_v2=())
    fault_dev = float((_panda_run(faulty, aux, PANDA_HOLD, 0)[0]
                       - q_cpu[:PANDA_HOLD]).abs().max())
    # float64, card against CPU
    m64 = build_model(PANDA_XML, max_contacts=PANDA_K, device="cuda", dtype=torch.float64)
    c64 = build_model(PANDA_XML, max_contacts=PANDA_K, device="cpu", dtype=torch.float64)
    q64, q64_cpu, q64_ulp = (_panda_run(*mm, PANDA64_STEPS, 0, ulp=u)[0]
                             for mm, u in ((m64, False), (c64, False), (c64, True)))
    dev64 = float((q64 - q64_cpu).abs().max())
    bound64 = max(1e-10, 2 * float((q64_ulp - q64_cpu).abs().max()))
    log(f"Panda witnesses: the card's own one-ulp spread over the {len(ms)} steps "
        f"{spread:.3e}, the card with the finger coupling dropped vs the CPU's sound run "
        f"{fault_dev:.3e} over the {PANDA_HOLD} hold steps: the bound {PANDA_TOL:g} lies "
        f"above twice the one and below the other; float64, {PANDA64_STEPS} control step, "
        f"card vs CPU max |qpos difference| {dev64:.3e} (bound {bound64:.3g}); on {card}",
        recap=True)
    assert 2 * spread <= PANDA_TOL < fault_dev, (spread, fault_dev)
    assert dev64 <= bound64, f"Panda float64: {dev64} from the CPU"
    return dict(step_ms=med(ms), step_ms_cpu=med(ms_cpu), ee_dx=end - held, finger_gap=gap,
                max_abs_dev_cpu=dev, bound=PANDA_TOL, one_ulp_spread=spread,
                fault_max_abs_dev_cpu=fault_dev, float64_max_abs_dev_cpu=dev64,
                float64_bound=bound64)


def run_trace(env, card):
    """One control step of the 4096-env main path under profiling.trace:
    the trace holds both kernels and the five stages' marks, which the
    substep graph's replays launch (they run no host range); the summed
    device time of its kernels, copies and sets against the step's wall
    time, traced and untraced."""
    import tempfile

    import torch

    from gym_so100_tpu_torch.profiling import trace

    gen = torch.Generator(device=env.device).manual_seed(SEED + 13)
    es = env.reset(seed=SEED + 14)
    acts = [torch.rand(env.num_envs, 6, generator=gen, device=env.device) * 2 - 1
            for _ in range(3)]
    es = env.step(es, acts[0])[0]            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es = env.step(es, acts[1])[0]
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        with trace(tmp, device="cuda"):
            t0 = time.perf_counter()
            env.step(es, acts[2])
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3
        path = Path(tmp) / "trace.json"
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    names = {e.get("name", "") for e in events}
    kernels = {k: sum(k in e.get("name", "") for e in device)
               for k in ("hull_sweep_kernel", "newton_solve_kernel")}
    stages = {k: sum(f"gst_span_{k}" in e.get("name", "") for e in device)
              for k in ("smooth", "collide", "efc", "solve", "integrate")}
    busy_ms = sum(float(e.get("dur", 0)) for e in device) / 1e3
    top = {}
    for e in device:
        top[e["name"][:60]] = top.get(e["name"][:60], 0.0) + float(e.get("dur", 0)) / 1e3
    top = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    log(f"trace: one {env.num_envs}-env control step, {size / 2**20:.1f} MiB, "
        f"{len(events)} events, {len(device)} device events; kernel launches in it "
        f"{kernels}; stage marks {stages}; summed device time {busy_ms:.2f} ms against "
        f"the traced step's wall {traced_wall:.1f} ms ({busy_ms / traced_wall:.4f}) and "
        f"an untraced step's {plain_wall:.1f} ms ({busy_ms / plain_wall:.4f}); largest "
        f"device items (ms): " + ", ".join(f"{n} {t:.2f}" for n, t in top)
        + f"; on {card}", recap=True)
    assert kernels == {"hull_sweep_kernel": 10, "newton_solve_kernel": 10}, kernels
    assert all(n == 10 for n in stages.values()), stages
    assert len(names) > 10
    return dict(device_ms=busy_ms, traced_wall_ms=traced_wall, wall_ms=plain_wall,
                busy_share=busy_ms / plain_wall, trace_mib=size / 2**20, events=len(events))


def _contacts_as_sets(a, b, tol):
    """Per env, match the active contacts of the Contacts `a` and `b`
    (fields (B, K, ...), CPU) by geom pair and nearest point; return the
    largest difference of depth, point and normal among the matched ones,
    and the count of contacts without a partner.  Slots are not compared in
    order: rounding can reorder contacts of equal depth (a box's corners on
    the table), and it turns the tangent rows of a frame whose normal is
    nearly a world axis.  A contact may lack a partner only where rounding
    can decide it: within `tol` of the activity bound (depth 0), or of the
    shallowest selected depth of an env with more candidates than slots."""
    B = a.dist.shape[0]
    worst, unmatched = 0.0, 0

    def edge(c, i, k):
        over = int(c.ncand[i]) > c.dist.shape[1]
        shallow = float(c.dist[i][c.active[i]].max())
        return abs(float(c.dist[i, k])) <= tol or (over and float(c.dist[i, k]) >= shallow - tol)

    for i in range(B):
        free = set(b.active[i].nonzero()[:, 0].tolist())
        for k in a.active[i].nonzero()[:, 0].tolist():
            pair = (int(a.geom1[i, k]), int(a.geom2[i, k]))
            cand = [j for j in free if (int(b.geom1[i, j]), int(b.geom2[i, j])) == pair]
            j = min(cand, default=None,
                    key=lambda j: float((a.pos[i, k] - b.pos[i, j]).abs().max()))
            if j is None or float((a.pos[i, k] - b.pos[i, j]).abs().max()) > tol:
                assert edge(a, i, k), f"env {i}: no match for the contact {k} of pair {pair}"
                unmatched += 1
                continue
            free.discard(j)
            worst = max(worst, abs(float(a.dist[i, k] - b.dist[i, j])),
                        float((a.pos[i, k] - b.pos[i, j]).abs().max()),
                        float((a.frame[i, k, 0] - b.frame[i, j, 0]).abs().max()))
        for j in free:
            assert edge(b, i, j), f"env {i}: no match for the contact {j}"
            unmatched += 1
    assert worst <= tol, f"matched contacts differ by {worst:.3g} > {tol:.3g}"
    return worst, unmatched


def run_batch_first(env, es, card):
    """The batch-first narrowphase on `es` (phase 3's 4096-env state after
    12 control steps, float32, K = 16): position_stage_batched once,
    counted (one hull-sweep launch, no solve); its Contact against
    collide_batched_lanes on the same Data, transposed; make_efc_batched
    against make_efc_from_lanes, transposed; BF_CPU_ENVS envs again on the
    CPU, where the route runs sweep_h_plain; both routes timed."""
    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.models.scene import Data
    from gym_so100_tpu_torch.ops import constraint_lanes, forward, smooth_lanes, solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes, narrowphase

    m, s = env.m, es.physics
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    d = forward.position_stage_batched(m, s)
    torch.cuda.synchronize()
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    assert launches == {"hull_sweep": 1, "newton_solve": 0}, launches
    con = d.contact
    B, K = con.dist.shape
    assert (B, K) == (NUM_ENVS, MAX_CONTACTS) and con.dist.dtype == torch.float32
    for name in ("dist", "pos", "frame"):
        assert bool(torch.isfinite(getattr(con, name)).all()), f"batch-first: {name} not finite"
    assert bool(con.active.any()), "batch-first: no active contact"

    # the lanes route on the same Data, transposed
    cl = narrowphase.collide_batched_lanes(m, d)
    T = lambda a: a.movedim(0, -1)
    for name in ("active", "geom1", "geom2", "condim"):
        assert torch.equal(getattr(cl, name), T(getattr(con, name))), f"batch-first: {name}"
    assert torch.equal(cl.ncand, con.ncand), "batch-first: ncand"
    err = {}
    pairs = {"dist": [(cl.dist, T(con.dist))],
             "pos": [(cl.pos[c], T(con.pos[..., c])) for c in range(3)],
             "frame": [(cl.frame[r][c], T(con.frame[..., r, c]))
                       for r in range(3) for c in range(3)]}
    for name, ab in pairs.items():
        rtol, atol = BF_TOL[name]
        err[name] = max(float((x - y).abs().max()) for x, y in ab)
        assert all(torch.allclose(x, y, rtol=rtol, atol=atol) for x, y in ab), (
            f"batch-first: {name} differs from the lanes route by {err[name]:.3g}")

    # constraint rows from the two forms of the contacts
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    dd = Data(cdof=sl["cdof"], subtree_com=sl["subtree_com0"][:, None],
              site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"])
    eb = constraint_lanes.make_efc_batched(m, dd, s, con)
    el = constraint_lanes.make_efc_from_lanes(m, dd, s, cl)
    lanes_t = {"J": el.J.permute(2, 1, 0), "con_uscale": el.con_uscale.permute(2, 0, 1)}
    unequal = [k for k in ("J", "aref", "D", "R", "pos", "con_mu", "con_uscale", "con_Dn",
                           "con_active")
               if not torch.equal(getattr(eb, k),
                                  lanes_t[k] if k in lanes_t else getattr(el, k).T)]
    # both read the same rows, but the two forms normalize a frame's t1 in
    # other orders, so a contact's tangent rows (J, and aref through J.qvel)
    # may differ by rounding where its two frames do; every other row and
    # field must be bit-equal
    cl_frame = torch.stack([torch.stack(cl.frame[r], -1) for r in range(3)], -2).transpose(0, 1)
    moved = ~(con.frame == cl_frame).all(-1).all(-1)                     # (B, K)
    start = el.neq + el.nf + el.nl
    may = torch.zeros_like(eb.aref, dtype=torch.bool)
    for j in (1, 2):
        may[:, start + j::constraint_lanes.CDIM] = moved
    assert set(unequal) <= {"J", "aref"}, f"batch-first: efc fields differ: {unequal}"
    efc_err = {}
    for k, a, b, scale in (("J", eb.J, lanes_t["J"], 1e-6), ("aref", eb.aref, el.aref.T, 1e-5)):
        diff = (a - b).abs()
        if diff.dim() == 3:
            diff = diff.amax(-1)
        assert not bool((diff[~may] > 0).any()), f"batch-first: {k} differs off the tangent rows"
        efc_err[k] = float(diff.max())
        bound = scale * max(1.0, float(b.abs().max()))
        assert efc_err[k] <= bound, f"batch-first: {k} differs by {efc_err[k]:.3g} > {bound:.3g}"
    assert bool(eb.is_floss[:, el.neq:el.neq + el.nf].all())
    assert torch.equal(eb.floss[:, el.neq:el.neq + el.nf], el.floss.T)

    # BF_CPU_ENVS envs on the CPU, where the route runs sweep_h_plain: from
    # the card's geom poses (the kernel's route against its plain version:
    # the same operations, slot by slot), and from the state (the whole
    # function, with the CPU's own kinematics)
    n = BF_CPU_ENVS
    m_cpu = m.to("cpu")
    rows = lambda c: c.index(slice(0, n)).to("cpu")
    con_card = rows(con)
    same = narrowphase.collide_batched(m_cpu, Data(geom_xpos=d.geom_xpos[:n].cpu(),
                                                   geom_xmat=d.geom_xmat[:n].cpu()))
    for name in ("active", "geom1", "geom2", "condim", "ncand"):
        assert torch.equal(getattr(same, name), getattr(con_card, name)), f"CPU route: {name}"
    plain_err = {}
    for name, (rtol, atol) in BF_TOL.items():
        a, b = getattr(same, name), getattr(con_card, name)
        plain_err[name] = float((a - b).abs().max())
        assert torch.allclose(a, b, rtol=rtol, atol=atol), (
            f"CPU route: {name} differs by {plain_err[name]:.3g}")
    d_cpu = forward.position_stage_batched(m_cpu, s.index(slice(0, n)).to("cpu"))
    pose_err = max(float((d_cpu.geom_xpos - d.geom_xpos[:n].cpu()).abs().max()),
                   float((d_cpu.geom_xmat - d.geom_xmat[:n].cpu()).abs().max()))
    assert pose_err <= BF_CPU_TOL, f"CPU kinematics differ by {pose_err:.3g}"
    set_err, unmatched = _contacts_as_sets(d_cpu.contact, con_card, BF_CPU_TOL)

    # times: the batch-first route, its collide stage, the lanes collide,
    # and the hull kernel on this route's inputs
    tb = hull_lanes.hull_tables(m)
    _, _, p_pack, R_pack = hull_inputs(m, d)
    out = torch.empty(4 * tb.P, B, device=p_pack.device)
    Vmax = tb.verts.shape[1] // 3
    kernel_ms = cuda_ms(lambda: kernels.launch(
        "gst_hull_sweep", p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2, out,
        tb.G, tb.D.shape[0], tb.P, Vmax, tb.vtot, B), 50)
    stage_ms = cuda_ms(lambda: forward.position_stage_batched(m, s), BF_REPS)
    collide_ms = cuda_ms(lambda: narrowphase.collide_batched(m, d), BF_REPS)
    lanes_ms = cuda_ms(lambda: narrowphase.collide_batched_lanes(m, d), BF_REPS)
    log(f"batch-first narrowphase: {int(con.active.sum())} active contacts in "
        f"{int(con.active.any(1).sum())}/{B} envs, launches {launches}; against the lanes "
        f"route: ints equal, max abs err dist {err['dist']:.3g} pos {err['pos']:.3g} "
        f"frame {err['frame']:.3g} ({int(moved.sum())} frames differ); efc rows: "
        f"{', '.join(unequal) or 'none'} differ, J {efc_err['J']:.3g}, aref "
        f"{efc_err['aref']:.3g}, other fields bit-equal"
        f"; CPU ({n} envs) from the card's poses: ints equal, dist {plain_err['dist']:.3g} "
        f"pos {plain_err['pos']:.3g} frame {plain_err['frame']:.3g}; from the state: poses "
        f"{pose_err:.3g}, contacts as sets {set_err:.3g} (bound {BF_CPU_TOL:g}), "
        f"{unmatched} unmatched at a bound", recap=True)
    log(f"batch-first times (CUDA events): position_stage_batched {stage_ms:.2f} ms, "
        f"collide_batched {collide_ms:.2f} ms, collide_batched_lanes {lanes_ms:.2f} ms, "
        f"hull kernel {kernel_ms:.4f} ms per launch, on {card}", recap=True)
    return {"hull_sweep": dict(launches=1, ms=kernel_ms, route_ms=stage_ms,
                               collide_ms=collide_ms, lanes_collide_ms=lanes_ms),
            "newton_solve": dict(launches=0)}


def _panda_batched_start(m, aux, B, ulp=False):
    """B envs of the Panda scene at "home", each env's arm joints moved by a
    seeded draw of at most PB_JITTER rad (with `ulp`, every nonzero qpos
    then one ulp up), each mocap target on its own ee site."""
    import numpy as np
    import torch

    from gym_so100_tpu_torch.models.scene import State
    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.ops import smooth_lanes

    kq, kc = aux["keyframes"]["home"]
    qpos = np.tile(np.asarray(kq, np.float64), (B, 1))
    qpos[:, :7] += np.random.RandomState(SEED + 11).uniform(
        -PB_JITTER, PB_JITTER, (PB_ENVS, 7))[:B]
    qpos = torch.tensor(qpos, dtype=m.dtype, device=m.device)
    if ulp:
        qpos = torch.where(qpos != 0, torch.nextafter(
            qpos, torch.full_like(qpos, float("inf"))), qpos)
    one = fwd.make_state(m, qpos=kq, ctrl=kc)
    s = State(qpos=qpos, qvel=torch.zeros(B, m.nv, dtype=m.dtype, device=m.device),
              ctrl=one.ctrl.expand(B, -1).clone(),
              mocap_pos=one.mocap_pos.expand(B, -1, -1).clone(),
              mocap_quat=one.mocap_quat.expand(B, -1, -1).clone(),
              qacc_warmstart=torch.zeros(B, m.nv, dtype=m.dtype, device=m.device))
    ee = m.site_id("ee_site")
    return s.replace(mocap_pos=smooth_lanes.kinematics(m, s).site_xpos[:, ee][:, None].clone())


def _panda_batched_run(m, s, hold=PB_HOLD, move=PB_MOVE):
    """`hold` control steps of n_steps_batched, then each target 3 cm along
    +x for `move` steps.  Returns (the first PB_TRACKED lanes' qpos per step
    (float64, CPU), the state after the last step, ee x of every lane after
    the hold and at the end, ms per step, the largest ncon)."""
    import torch

    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.ops import smooth_lanes

    ee = m.site_id("ee_site")
    kin_x = lambda s: smooth_lanes.kinematics(m, s).site_xpos[:, ee, 0].clone()
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)
    qs, ms, held, ncon = [], [], None, 0
    for i in range(hold + move):
        if i == hold:
            held = kin_x(s)
            s = s.replace(mocap_pos=s.mocap_pos + torch.tensor(
                [0.03, 0.0, 0.0], dtype=s.mocap_pos.dtype, device=m.device))
        sync()
        t0 = time.perf_counter()
        s, nc = fwd.n_steps_batched(m, s, 10)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        qs.append(s.qpos[:PB_TRACKED].double().cpu())
        ncon = max(ncon, int(nc.max()))
    return torch.stack(qs), s, held, kin_x(s), ms, ncon


def run_panda_batched(card):
    """The batched lanes step of the Panda EE scene on the card: PB_ENVS
    envs, K = PANDA_K, float32, nv = 15; PB_HOLD control steps holding
    each mocap target on its ee, then PB_MOVE after moving it 3 cm along
    +x, counted (10 launches of each kernel per control step).  Finite, the
    fingers coupled in every lane, the first PB_TRACKED lanes' ee moved >
    1.5 cm along +x (tests/test_panda.py's criteria); both kernels against
    their plain versions on the state after the move (the hull tables
    bit-equal, the Newton solve by the floor rule), timed; the first
    PB_TRACKED lanes held to the same steps on the CPU within PB_TOL, above
    twice the card's own one-ulp spread and below a planted fault.
    Returns {kernel: dict(launches, check and time fields, nv)} and the
    phase's numbers."""
    import dataclasses
    import types

    import numpy as np
    import torch

    from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    m, aux = build_model(PANDA_XML, max_contacts=PANDA_K, device="cuda")
    tb = hull_lanes.hull_tables(m)
    log(f"Panda batched: {PB_ENVS} envs, K {PANDA_K}, float32, nv {m.nv}, "
        f"{len(m.eq_site1)} weld and {len(m.eq_jnt_q1)} joint equality; pairs "
        f"{len(m.pairs.box_box)} box-box / {len(m.pairs.hull_box)} hull-box / "
        f"{len(m.pairs.hull_hull)} hull-hull; hull tables G {tb.G}, ND {tb.D.shape[0]}, "
        f"P {tb.P}; {PB_HOLD} hold + {PB_MOVE} move control steps", recap=True)
    s0 = _panda_batched_start(m, aux, PB_ENVS)
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    qs, s, held, end, ms, ncon = _panda_batched_run(m, s0)
    torch.cuda.synchronize()
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    n_steps = PB_HOLD + PB_MOVE
    for name, n in launches.items():
        assert n == 10 * n_steps, f"Panda batched: {name} {n} launches, expected {10 * n_steps}"
    assert bool(torch.isfinite(s.qpos).all() and torch.isfinite(s.qvel).all()), \
        "Panda batched: state not finite"
    q1 = s.qpos[:, m.jnt_qposadr[m.joint_id("finger_joint1")]]
    q2 = s.qpos[:, m.jnt_qposadr[m.joint_id("finger_joint2")]]
    gap = float((q1 - q2).abs().max())
    dx = end - held
    n = PB_TRACKED
    step = float(np.mean(ms[1:]))
    log(f"Panda batched: launches {launches}, ncon max {ncon}; finger gap max over "
        f"{PB_ENVS} lanes {gap:.2e} (bound 5e-3); ee moved along x: min "
        f"{float(dx.min()):+.4f} median {float(dx.median()):+.4f} m, first {n} "
        f"{[round(x, 4) for x in dx[:n].tolist()]} (bound > 0.015); control step "
        f"{step:.1f} ms (host clock, mean of steps 2-{n_steps}; the first {ms[0]:.1f} ms), "
        f"{PB_ENVS / step * 1e3:.1f} env-steps/s; on {card}", recap=True)
    assert gap < 5e-3, "Panda batched: the fingers decoupled"
    assert bool((dx[:n] > 0.015).all()), "Panda batched: an ee did not follow along +x"

    env = types.SimpleNamespace(m=m)
    moved = types.SimpleNamespace(physics=s)
    rows = {"hull_sweep": check_hull(env, moved, timed=True),
            "newton_solve": check_solver(env, moved, timed=True,
                                         floor_samples=FLOOR_SAMPLES)}
    assert rows["hull_sweep"]["max_abs_err"] == 0.0, "Panda batched: hull tables differ"

    # the first lanes on the CPU, and the witnesses of PB_TOL: the card
    # against itself from a one-ulp start, and the finger coupling dropped
    t0 = time.perf_counter()
    m_cpu, aux_cpu = build_model(PANDA_XML, max_contacts=PANDA_K, device="cpu")
    q_cpu = _panda_batched_run(m_cpu, _panda_batched_start(m_cpu, aux_cpu, n))[0]
    cpu_s = time.perf_counter() - t0
    dev_q = (qs - q_cpu).abs()                          # (steps, lanes, nq)
    spread_q = (_panda_batched_run(
        m, _panda_batched_start(m, aux, PB_ENVS, ulp=True))[0] - qs).abs()
    dev, spread = float(dev_q.max()), float(spread_q.max())
    # where the two peak: each joint's largest qpos difference (the free
    # joint's 7 entries as one), and each lane's
    names = m.names_joint
    adr = list(m.jnt_qposadr) + [m.nq]
    by_joint = lambda d: {names[j]: float(d[..., adr[j]:adr[j + 1]].max())
                          for j in range(len(names))}
    fmt = lambda x: "{" + ", ".join(f"{k}: {v:.1e}" for k, v in x.items()) + "}"
    faulty = dataclasses.replace(m, eq_jnt_q1=(), eq_jnt_q2=(), eq_jnt_v1=(), eq_jnt_v2=())
    fault_dev = float((_panda_batched_run(
        faulty, _panda_batched_start(m, aux, n), PB_HOLD, 0)[0]
        - q_cpu[:PB_HOLD]).abs().max())
    log(f"Panda batched: first {n} lanes, card vs CPU max |qpos difference| {dev:.3e} "
        f"over the {n_steps} steps (bound {PB_TOL:g}); the card's own one-ulp spread "
        f"{spread:.3e}, the card with the finger coupling dropped vs the CPU's sound run "
        f"{fault_dev:.3e} over the {PB_HOLD} hold steps; CPU run {cpu_s:.1f} s; on "
        f"{card}", recap=True)
    log(f"Panda batched: by joint, card vs CPU {fmt(by_joint(dev_q))}; one-ulp spread "
        f"{fmt(by_joint(spread_q))}; by lane, card vs CPU "
        f"{[float(f'{x:.1e}') for x in dev_q.amax((0, 2)).tolist()]}, one-ulp spread "
        f"{[float(f'{x:.1e}') for x in spread_q.amax((0, 2)).tolist()]}", recap=True)
    assert dev <= PB_TOL, f"Panda batched: {dev} from the CPU"
    assert 2 * spread <= PB_TOL < fault_dev, (spread, fault_dev)
    log(f"Panda batched kernels: hull {rows['hull_sweep']['ms']:.4f} ms, Newton (nv = "
        f"{m.nv}) {rows['newton_solve']['ms']:.4f} ms per launch, x 10 = "
        f"{10 * (rows['hull_sweep']['ms'] + rows['newton_solve']['ms']) / step:.4f} of a "
        f"control step; on {card}", recap=True)
    numbers = dict(step_ms=step, env_steps_per_s=PB_ENVS / step * 1e3, finger_gap=gap,
                   ee_dx_min=float(dx.min()), ncon_max=ncon, max_abs_dev_cpu=dev,
                   bound=PB_TOL, one_ulp_spread=spread, fault_max_abs_dev_cpu=fault_dev)
    return {name: dict(launches=launches[name], nv=m.nv, **rows[name]) for name in rows}, numbers


def _multicube_start(m, B):
    """B envs of a multi-cube scene at qpos0, each env's arm joints moved by
    a seeded draw of at most MC_JITTER rad, the arm's servos at 0."""
    import numpy as np
    import torch

    from gym_so100_tpu_torch.models.scene import State

    qpos = np.tile(m.qpos0.double().cpu().numpy(), (B, 1))
    qpos[:, :6] += np.random.RandomState(SEED + 13).uniform(-MC_JITTER, MC_JITTER, (B, 6))
    zeros = lambda *shape: torch.zeros(*shape, dtype=m.dtype, device=m.device)
    return State(qpos=torch.tensor(qpos, dtype=m.dtype, device=m.device), qvel=zeros(B, m.nv),
                 ctrl=zeros(B, m.nu), mocap_pos=zeros(B, 0, 3), mocap_quat=zeros(B, 0, 4),
                 qacc_warmstart=zeros(B, m.nv))


def _multicube_run(m, B, card):
    """MC_STEPS control steps of n_steps_batched from _multicube_start,
    counted: 10 launches of each kernel per step, finite, ncon <= K, every
    resting cube within MC_REST_TOL of z = 0.02.  Returns (state, launches,
    ms per step, ncon max)."""
    import torch

    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    s = _multicube_start(m, B)
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    ms, ncon = [], 0
    for _ in range(MC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, nc = fwd.n_steps_batched(m, s, 10)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ncon = max(ncon, int(nc.max()))
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    cubes = (m.nv - 12) // 6
    z = torch.stack([s.qpos[:, m.jnt_qposadr[m.joint_id(f"cube{i}_joint")] + 2]
                     for i in range(cubes)])
    rest = float((z - 0.02).abs().max())
    step = sum(ms[1:]) / len(ms[1:])
    log(f"multi-cube (nv {m.nv}): {B} envs, launches {launches}, ncon max {ncon} (K "
        f"{m.max_contacts}); resting cubes' |z - 0.02| max {rest:.2e} m (bound "
        f"{MC_REST_TOL:g}); control step {step:.1f} ms (host clock, mean of steps "
        f"2-{MC_STEPS}; the first {ms[0]:.1f} ms), {B / step * 1e3:.1f} env-steps/s; on {card}",
        recap=True)
    for name, n in launches.items():
        assert n == 10 * MC_STEPS, f"multi-cube: {name} {n} launches, expected {10 * MC_STEPS}"
    assert bool(torch.isfinite(s.qpos).all() and torch.isfinite(s.qvel).all()), \
        "multi-cube: state not finite"
    assert ncon <= m.max_contacts, f"multi-cube: ncon {ncon} > K"
    assert rest <= MC_REST_TOL, f"multi-cube: a resting cube moved {rest} m off the table"
    return s, launches, step, ncon


def run_multicube(card):
    """The batched lanes step of the five-cube SO100 scene (float32, K =
    MC_K, nv = 36: the Newton kernel's runtime-nv build) at MC_ENVS envs,
    MC_STEPS control steps from rest, counted (10 launches of each kernel per
    step); both kernels against their plain versions on the state after
    them (the hull tables bit-equal, the Newton solve by the floor rule, a
    planted fault missing it: one cube's J rows zeroed), timed; then the
    one-extra-cube scene (nv = 18) at MC18_ENVS envs the same way, the
    Newton kernel checked and timed there.  Returns {kernel: row} and the
    phase's numbers."""
    import dataclasses
    import tempfile
    import types

    from gym_so100_tpu_torch.models.builder import build_model
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    with tempfile.TemporaryDirectory() as tmp:
        m, _ = build_model(str(write_multicube_scene(tmp)), max_contacts=MC_K, device="cuda")
        m18, _ = build_model(str(write_multicube_scene(tmp, 1)), max_contacts=MC_K,
                             device="cuda")
    tb = hull_lanes.hull_tables(m)
    log(f"multi-cube: so100_transfer_cube.xml + {MC_CUBES} free cubes, float32, K {MC_K}, "
        f"nq {m.nq} nv {m.nv} ngeom {m.ngeom}; pairs {len(m.pairs.box_box)} box-box / "
        f"{len(m.pairs.hull_box)} hull-box / {len(m.pairs.hull_hull)} hull-hull; hull "
        f"tables G {tb.G}, ND {tb.D.shape[0]}, P {tb.P}", recap=True)
    s, launches, step, ncon = _multicube_run(m, MC_ENVS, card)
    cube = m.jnt_dofadr[m.joint_id("cube0_joint")]

    def drop_cube(efc):          # the planted fault: cube0's dofs lose their J rows
        J = efc.J.clone()
        J[cube:cube + 6] = 0
        return dataclasses.replace(efc, J=J)

    env = types.SimpleNamespace(m=m)
    es = types.SimpleNamespace(physics=s)
    rows = {"hull_sweep": check_hull(env, es, timed=True),
            "newton_solve": check_solver(env, es, timed=True, floor_samples=FLOOR_SAMPLES,
                                         fault=drop_cube)}
    assert rows["hull_sweep"]["max_abs_err"] == 0.0, "multi-cube: hull tables differ"
    shape = rows["newton_solve"]["launch_shape"]
    s18, launches18, step18, _ = _multicube_run(m18, MC18_ENVS, card)
    row18 = check_solver(types.SimpleNamespace(m=m18), types.SimpleNamespace(physics=s18),
                         timed=True, floor_samples=FLOOR_SAMPLES)
    log(f"multi-cube kernels: hull {rows['hull_sweep']['ms']:.4f} ms (bound "
        f"{rows['hull_sweep']['bound_ms']:.4f}, plain {rows['hull_sweep']['plain_ms']:.4f}), "
        f"Newton nv = {m.nv} {rows['newton_solve']['ms']:.4f} ms (bound "
        f"{rows['newton_solve']['bound_ms']:.4f}, plain {rows['newton_solve']['plain_ms']:.4f}; "
        f"{shape[0]} envs per block, {shape[2]} B), nv = {m18.nv} {row18['ms']:.4f} ms (bound "
        f"{row18['bound_ms']:.4f}, plain {row18['plain_ms']:.4f}) per launch; on {card}",
        recap=True)
    rows["hull_sweep"].update(launches=launches["hull_sweep"], G=tb.G, P=tb.P)
    wide = rows["newton_solve"]
    ptxas = ptxas_lines("newton_solve_wide")
    log(f"multi-cube Newton kernel (runtime nv): {shape[0]} env per block, {shape[1]} "
        f"threads ({shape[1] // 32} warps), {shape[2]} B of shared memory; ptxas: "
        f"{'; '.join(ptxas) or 'not in the log (a cached build)'}; nv = {m.nv}: niter mean "
        f"{wide['niter_mean']:.4f}, mean over groups of 4 envs of their max "
        f"{wide['niter_max4_mean']:.4f}", recap=True)
    wide.update(launches=launches["newton_solve"], nv=m.nv, envs_per_block=shape[0],
                threads_per_block=shape[1], smem_bytes=shape[2], ptxas=ptxas)
    row18.update(launches=launches18["newton_solve"], nv=m18.nv)
    numbers = dict(step_ms=step, env_steps_per_s=MC_ENVS / step * 1e3, ncon_max=ncon,
                   step_ms_nv18=step18, env_steps_per_s_nv18=MC18_ENVS / step18 * 1e3)
    return rows, row18, numbers


def run_chain_probe(card):
    """The chain probe's kernel (csrc/chain_probe.cu) on the probe's inputs
    at its B: held to chain_plain on the card at n = 50 and n = 10, bit-equal
    on the finite components, the non-finite ones the same set (nan where
    nan, the same infinities), every lane finite at n = 10; one launch per
    call, counted; then rows (a), (b), (d) and (p) of the probe's `main`,
    counted, row (d) with the kernel's device time at n = 0, 50 and 200:
    its fixed cost and its time per iteration, and the card's dependent
    latency and SM clock measured for the chain's floor.  Returns the
    kernel's row, whose bound is the largest of three terms."""
    import torch

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.scripts import probe_chain as pc

    q, v, M = (torch.from_numpy(a).to("cuda") for a in pc.probe_inputs(pc.B))
    shape = kernels.launch_shape("gst_chain_probe", pc.B)
    log_shape("chain_probe", shape, pc.B)
    checks = {}
    for n in (pc.N, CHAIN_SHORT):
        c = pc.compare(pc.chain_fused(q, v, M, n), pc.chain_plain(q, v, M, n))
        torch.cuda.synchronize()
        log(f"chain probe check n = {n}: max abs err {c['max_abs_err']:.3g} over the finite "
            f"components, non-finite the same set {c['same_nonfinite']}, "
            f"{c['nonfinite_lanes']}/{c['lanes']} lanes non-finite", recap=True)
        assert c["same_nonfinite"], f"chain probe n = {n}: non-finite components differ"
        assert c["max_abs_err"] == 0.0, f"chain probe n = {n}: differs by {c['max_abs_err']}"
        checks[n] = c
    assert checks[CHAIN_SHORT]["nonfinite_lanes"] == 0, "chain probe: n = 10 not finite"
    pc.chain_fused.launches = 0
    pc.chain_fused(q, v, M, pc.N)
    torch.cuda.synchronize()
    assert pc.chain_fused.launches == 1, f"chain probe: {pc.chain_fused.launches} launches"
    # the probe's rows, counted
    pc.chain_fused.launches = 0
    res = pc.timings(q, v, M, rows="abdp", log=log, card=card)
    torch.cuda.synchronize()
    launches = pc.chain_fused.launches
    assert launches == res["kernel_calls"], (launches, res["kernel_calls"])
    # least work: 16 floats read and 3 written per env; OPS_PER_ITER separate
    # float operations per env and iteration, at the rate without multiply-
    # add (the build contracts none); and CHAIN_DEPTH of them per iteration
    # one after another, at the latency and clock measured in this run
    nbytes = 4 * (q.numel() + v.numel() + M.numel() + 3 * pc.B)
    terms = dict(bytes_ms=nbytes / H100_BYTES_PER_S * 1e3,
                 ops_ms=pc.OPS_PER_ITER * pc.N * pc.B / (H100_F32_OPS_PER_S / 2) * 1e3,
                 chain_ms=res["chain_floor_ms"])
    bound = dict(bound_ms=max(terms.values()),
                 bound_by="bytes" if terms["bytes_ms"] >= max(terms.values()) else "operations")
    lat = res["latency"]
    # the kernel's own device time where the trace has it; a call from
    # Python takes longer than the kernel, so the events time the host
    ms = res.get("d_device_ms") or res["d_ms"]
    log(f"kernel chain_probe: {ms:.4f} ms per launch ("
        f"{'profiler' if res.get('d_device_ms') else 'CUDA events'}; {res['d_ms']:.4f} ms per "
        f"call from Python), bound {bound['bound_ms']:.6f} ms (the largest of bytes "
        f"{terms['bytes_ms']:.6f}, operations without multiply-add {terms['ops_ms']:.6f}, "
        f"the dependent chain {terms['chain_ms']:.6f}), plain "
        f"{res['p_ms']:.4f} ms, {launches} launches, on {card}", recap=True)
    fixed, per = res.get("d_fixed_ms"), res.get("d_us_per_iter")
    log(f"chain probe kernel: {shape[0]} envs per block, {shape[1]} threads, "
        f"{-(-pc.B // shape[0])} blocks; fixed cost (n = 0) "
        + (f"{fixed:.5f} ms, {per * 1e3:.2f} ns per iteration" if per is not None
           else "not measured")
        + (f" ({res['d_cycles_per_iter']:.1f} cycles)" if per is not None else "")
        + f"; dependent FMUL/FADD {lat['cycles_per_op']['fmul_fadd']:.3f} cycles at "
        f"{lat['sm_clock_ghz']:.4f} GHz (measured); on {card}", recap=True)
    return dict(
        name="chain_probe", route="cuda", source="gym_so100_tpu_torch/csrc/chain_probe.cu",
        replaces="devtools/probe_pallas.py:115", launches=launches,
        max_abs_err=checks[pc.N]["max_abs_err"], ms=ms, call_ms=res["d_ms"],
        plain_ms=res["p_ms"], **bound, library_ms=None,
        check_stat="max |kernel - plain| over the finite components at n = 50 and 10 "
                   "(the non-finite ones equal as sets)",
        check_value=max(c["max_abs_err"] for c in checks.values()), check_bound=0.0,
        nonfinite_lanes={str(n): c["nonfinite_lanes"] for n, c in checks.items()},
        bound_terms=terms, fixed_ms=fixed, us_per_iter=per,
        cycles_per_iter=res.get("d_cycles_per_iter"), latency_cycles=lat["cycles_per_op"],
        sm_clock_ghz=lat["sm_clock_ghz"], envs_per_block=shape[0], threads_per_block=shape[1],
        ptxas=ptxas_lines("chain_probe_kernel"),
        probe={k: res.get(k) for k in ("a_ms", "a_kernels", "b_ms", "us_per_iter",
                                       "us_per_kernel", "d_over_a")},
    )


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "gym_so100_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    from gym_so100_tpu_torch import kernels
    from gym_so100_tpu_torch.ops import solver_lanes
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{kernels.build_info.get('seconds', 0.0):.1f} s) -> {kernels.build_info['path']}",
        recap=True)
    # ptxas prints, per kernel, its name, then its spill and register lines;
    # the Newton kernel once per instantiated nv, then its runtime-nv kernel
    for line in kernels.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            nv = re.search(r"newton_solve_kernelILi(\d+)E", line)
            tag = (f" [Newton, nv = {nv[1]}]" if nv else
                   " [Newton, runtime nv]" if "newton_solve_wide" in line else "")
            log(f"  ptxas: {line.strip()}{tag}", recap=True)

    # 2. the card
    smi = gpu_name_and_power()
    name = torch.cuda.get_device_name(0)
    card = smi or f"{name}, power limit not readable"
    log(f"card: {card}")

    # 3. kernel checks at the main path's shapes
    t0 = time.perf_counter()
    env = BatchedEnv(task=TASK, num_envs=NUM_ENVS, device="cuda", seed=SEED,
                     max_contacts=MAX_CONTACTS)
    log(f"model: nq {env.m.nq} nv {env.m.nv} ngeom {env.m.ngeom}, pairs "
        f"{len(env.m.pairs.box_box)} box-box / {len(env.m.pairs.hull_box)} hull-box / "
        f"{len(env.m.pairs.hull_hull)} hull-hull, K {env.m.max_contacts} "
        f"({time.perf_counter() - t0:.1f} s)")
    # the cube touching down on the table, then landed with the arm about it
    gen = torch.Generator(device=env.device).manual_seed(SEED + 1)
    es = advance(env, env.reset(seed=SEED), WARM_STEPS, gen)
    steps = WARM_STEPS
    while solver_problem(env, es)[2].con_active.any(0).float().mean() < 0.5:
        assert steps < WARM_STEPS + TOUCHDOWN_MAX, "no touchdown: too few envs have a contact"
        es = advance(env, es, 1, gen)
        steps += 1
    log(f"touchdown after {steps} control steps", recap=True)
    check_hull(env, es, timed=False)
    check_solver(env, es, timed=False)
    es = advance(env, es, LANDED_STEPS - steps, gen)
    landed = es
    rows = [check_hull(env, es, timed=True),
            check_solver(env, es, timed=True, floor_samples=FLOOR_SAMPLES)]
    hull_padded = check_hull_padded(env, es)

    # 4. the main path, counted
    hull_lanes.sweep_h.launches = 0
    solver_lanes.solve_fused.launches = 0
    resets, es = run_main_path(env, MAIN_STEPS)
    torch.cuda.synchronize()
    launches = {"hull_sweep": hull_lanes.sweep_h.launches,
                "newton_solve": solver_lanes.solve_fused.launches}
    log(f"main path: {MAIN_STEPS} control steps x {NUM_ENVS} envs, {resets} "
        f"auto-resets, launches {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        assert row["launches"] == 10 * MAIN_STEPS, (
            f"{row['name']}: {row['launches']} launches, expected {10 * MAIN_STEPS}")

    gen = torch.Generator(device=env.device).manual_seed(SEED + 4)
    actions = [torch.rand(NUM_ENVS, 6, generator=gen, device=env.device) * 2 - 1
               for _ in range(TIMED_STEPS)]
    es = env.step(es, actions[0])[0]       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in actions:
        es = env.step(es, a)[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"throughput: {NUM_ENVS * TIMED_STEPS / dt:.1f} env-steps/s "
        f"({dt / TIMED_STEPS * 1e3:.1f} ms per control step, {NUM_ENVS} envs, "
        f"f32, hulls on, K={MAX_CONTACTS}) on {card}")
    stage_times(env, es)
    for row in rows:
        log(f"kernel {row['name']}: {row['ms']:.4f} ms per launch, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"{row['launches']} launches, on {card}")

    # 5. the training path, counted
    train = run_training(card)

    # 6. the pixel env and pixel training, counted
    t0 = time.perf_counter()
    pixel_env = run_pixel_env(card)
    train_pixels = run_pixel_training(card)
    log(f"pixel phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 7. HER, counted
    t0 = time.perf_counter()
    her = run_her(card)
    log(f"HER phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 8. the Cartesian (mocap-weld) env, counted, with kernel checks at neq = 6
    t0 = time.perf_counter()
    ee = run_ee(card)
    log(f"EE phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 9. the single env (the Gymnasium API), counted: neither kernel
    t0 = time.perf_counter()
    single = run_single_env(card)
    single["phase_s"] = time.perf_counter() - t0
    log(f"single-env phase: {single['phase_s']:.1f} s wall time (the CPU runs "
        f"{single['cpu_s']:.1f} s) on {card}", recap=True)

    # 10. multi-GPU: the trainer on 2 ranks (gloo) and on 1 rank (NCCL)
    t0 = time.perf_counter()
    dist_rows = run_dist(card)
    log(f"multi-GPU phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 11. the Panda EE scene
    t0 = time.perf_counter()
    panda = run_panda(card)
    log(f"Panda phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 12. a profiler trace of one 4096-env control step
    t0 = time.perf_counter()
    traced = run_trace(env, card)
    log(f"trace phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 13. the batch-first narrowphase on phase 3's landed state, counted
    t0 = time.perf_counter()
    batch_first = run_batch_first(env, landed, card)
    log(f"batch-first phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 14. the batched Panda step (nv = 15), counted
    t0 = time.perf_counter()
    panda_batched, pb_numbers = run_panda_batched(card)
    log(f"Panda batched phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 15. the five-cube scene (nv = 36) and the one-extra-cube scene (nv =
    # 18): the runtime-nv Newton kernel, counted
    t0 = time.perf_counter()
    multicube, mc_nv18, mc_numbers = run_multicube(card)
    log(f"multi-cube phase: {time.perf_counter() - t0:.1f} s wall time", recap=True)

    # 16. the chain probe's kernel, counted
    t0 = time.perf_counter()
    chain = run_chain_probe(card)
    chain["phase_s"] = time.perf_counter() - t0
    log(f"chain probe phase: {chain['phase_s']:.1f} s wall time on {card}", recap=True)

    # 17. results
    for line in RECAP:
        log(f"recap: {line}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "check_stat",
            "check_value", "check_bound")
    train_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "check_value", "check_bound")
    ee_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "check_value", "check_bound", "neq")
    print(json.dumps({"single_env": single, "panda": panda, "panda_batched": pb_numbers,
                      "multicube": mc_numbers, "trace": traced}), flush=True)
    rows[0]["padded"] = {"envs_per_block": {str(E): dict(G=G) for E, G in hull_padded.items()},
                         "max_abs_err": 0.0}
    rows[0]["multicube"] = {k: multicube["hull_sweep"][k] for k in train_keys + ("G", "P")}
    # the runtime-nv Newton kernel: its own row, from the five-cube phase
    wide = {**{k: multicube["newton_solve"][k] for k in keys},
            "name": "newton_solve_wide", "nv": multicube["newton_solve"]["nv"],
            "NE": multicube["newton_solve"]["NE"],
            **{k: multicube["newton_solve"][k] for k in (
                "envs_per_block", "threads_per_block", "smem_bytes", "ptxas", "niter_mean",
                "niter_max4_mean")},
            "nv18": {k: mc_nv18[k] for k in train_keys + ("nv",)}}
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         "train_k32": {k: train[row["name"]][k] for k in train_keys},
         "pixel_env": {"launches": pixel_env[row["name"]]},
         "train_pixels": {"launches": train_pixels[row["name"]]},
         "her": {k: her[row["name"]][k] for k in train_keys},
         "ee": {k: ee[row["name"]][k] for k in ee_keys},
         "dist": dist_rows[row["name"]],
         "batch_first": batch_first[row["name"]],
         "panda_batched": {k: panda_batched[row["name"]][k] for k in train_keys + ("nv",)},
         **{k: row[k] for k in ("padded", "multicube") if k in row}}
        for row in rows] + [wide, chain]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
