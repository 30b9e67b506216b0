"""The program `batched_env`: `gym_so100_tpu_torch`'s public batched env
step, `BatchedEnv.step`, driven in a closed loop.

The configuration (`benchmark/configs/<config>.json`) gives the scene,
task, precision, contact slots and observation mode; the traffic file
(`benchmark/traffic/<traffic>.json`) is read by `traffic.Traffic`.  The
check is `benchmark/check.py`'s, the faults `benchmark/faults.py`'s.  The
module contract is `benchmark/programs/__init__.py`'s.
"""

from __future__ import annotations

import os
import sys
import time

from benchmark import check, faults as fault_mod
from benchmark import trace as tracing
from benchmark import traffic as traffic_mod


def traffic(spec, seed, device):
    return traffic_mod.Traffic(spec, seed, device)


def build(config, spec, seed, device):
    """The program's batched env for the configuration, `spec["envs"]` wide."""
    import torch

    from gym_so100_tpu_torch.models.builder import build_model
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    if config["dtype"] != "float32":
        raise ValueError("the configurations run in float32")
    os.environ["GST_OBS_TRIS"] = str(config["tris_per_mesh"])
    m, aux = build_model(str(check.ROOT / config["scene_xml"]),
                         max_contacts=config["max_contacts"], device=device, dtype=torch.float32)
    return BatchedEnv(m, task=config["task"], num_envs=int(spec["envs"]),
                      hull_contacts=config["hull_contacts"], obs_mode=config["obs_mode"],
                      device=device, seed=seed, max_contacts=config["max_contacts"],
                      obs_height=config["obs_height"], obs_width=config["obs_width"],
                      render_aux=aux)


def _nonfinite(es, obs, reward):
    """(B,) envs whose returned state, obs or reward is not finite."""
    import torch

    bad = ~torch.isfinite(reward)
    for x in (es.physics.qpos, es.physics.qvel):
        bad |= ~torch.isfinite(x).all(1)
    o = obs["agent_pos"] if isinstance(obs, dict) else obs
    return bad | ~torch.isfinite(o).all(1)


def drive(run, env, traffic, device, seconds, trace=False, t_process=None, sync=None):
    """Reset, warm up, then the window: control steps in a closed loop until
    `seconds` have passed (the step under way then finishes and counts) and
    the checked steps are done (`seconds=0`: just those).  Keeps the
    checked steps' records in `run.records`.  With `trace`, once the window
    has closed, the next control step in which an episode ends runs under
    the profiler, outside the window, and its Trace goes to `run.trace`."""
    import torch

    sync = sync or (lambda: torch.cuda.synchronize(device))
    mark = (lambda k: run.marks.__setitem__(k, time.perf_counter() - t_process)) \
        if t_process is not None else (lambda k: None)
    poses, ages = traffic.initial()
    es = env.reset(box_pose=poses)
    es = es.replace(t=ages)
    run.start = (check.state_only(es), poses, ages)
    sync()
    mark("reset")
    for _ in range(int(traffic.spec["warmup_steps"])):
        es = env.step(es, *traffic.step_inputs())[0]
    sync()
    mark("warm-up")
    wanted = set(traffic.check_steps())
    min_steps = int(traffic.spec["check"]["last"]) + 1
    bad = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    if t_process is not None:
        run.setup_s = t0 - t_process
    i = 0
    while True:
        actions, spawn = traffic.step_inputs()
        rec = None
        if i in wanted:
            rec = check.Record(i, check.state_only(es), actions.clone(), spawn.clone())
        ts, cs = time.perf_counter(), time.thread_time()
        out = env.step(es, actions, reset_box_pose=spawn)
        es2, obs, reward, term, trunc, info = out
        bad += _nonfinite(es2, obs, reward).sum()
        if rec is not None:
            rec.out = check.outputs_of(es2, obs, reward, term, trunc, info["final_obs"])
            run.records.append(rec)
        es = es2
        i += 1
        run.step_s.append(time.perf_counter() - ts)
        run.cpu_s.append(time.thread_time() - cs)
        if time.perf_counter() - t0 >= seconds and i >= min_steps:
            break
    sync()
    run.window_s = time.perf_counter() - t0
    run.steps = i
    run.env_steps = i * traffic.envs
    run.failed = int(bad)
    if trace:
        # the traced step is one in which an episode ends, as every step at
        # 4096 envs is, so that every run traces the same work: at a few
        # hundred envs most steps reset no env and run ~5,000 fewer ops
        limit = int(run.config["episode_steps"])
        while not bool((es.t + 1 >= limit).any()):
            es = env.step(es, *traffic.step_inputs())[0]
        actions, spawn = traffic.step_inputs()
        out, prof = tracing.capture(lambda: env.step(es, actions, reset_box_pose=spawn))
        es = out[0]
        run.trace = tracing.from_kineto(prof.profiler.kineto_results.events())
        kernels = [e.name for e in run.trace.device_ops() if e.kind == "kernel"]
        print(f"traced step: hull_sweep launches {sum('hull_sweep' in n for n in kernels)}, "
              f"newton_solve launches {sum('newton_solve' in n for n in kernels)}",
              file=sys.stderr)
    return es


def kernel_shapes(ref, spec):
    """The cell's shapes that the roofline readers take, worked out from
    the reference's own model (its constraint rows at one resting env)."""
    import torch

    from benchmark.reference.models.scene import Data
    from benchmark.reference.ops import constraint_lanes, smooth_lanes
    from benchmark.reference.ops.collision import hull_lanes, narrowphase

    m = ref.env.m
    tb = hull_lanes.hull_tables(m)
    pose = torch.tensor([[-0.2, 0.45, 0.05, 1.0, 0.0, 0.0, 0.0]], dtype=m.dtype, device=m.device)
    es = ref.env.reset(pose)
    s = es.physics
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    return dict(
        B=int(spec["envs"]), nv=m.nv, K=m.max_contacts, neq=efc.neq, nf=efc.nf, nl=efc.nl,
        hull=dict(G=tb.G, ND=int(tb.D.shape[0]), P=tb.P, Vmax=tb.verts.shape[1] // 3,
                  counts=[int(c) for c in tb.counts.tolist()]),
    )


def verify(run, config, device, ref=None):
    """The reference's check of the run's records; returns (correct,
    [(name, value, limit)], the Reference, the Tally)."""
    ref = ref or check.Reference(config, device)
    tally = check.Tally(ref.pixels, config["check"]["off_gap"])
    before, poses, ages = run.start
    tally.start(ref, before, poses, ages)
    for rec in run.records:
        tally.add(ref, rec, rec.out, ref.step(rec, observe=False))
    correct, rows = check.judge(tally.numbers(), config["limits"], tally.steps)
    return correct, rows, ref, tally


def limit_names(config):
    names = {"state_gap_p90", "envs_off_pct", "answer_gap", "terminal_gap", "reset_errors"}
    if config["obs_mode"] == "pixels_agent_pos":
        names |= {"frame_gap", "terminal_frame_gap"}
    return names


def faults(config, device):
    """{name: plant} for `benchmark/faults.py`'s faults that the
    configuration can have; each wraps the env's `step` before its first
    step, so on the card the substep graph captured there holds it."""
    def plant(fault):
        def planted(env):
            env.step = fault(env.step)
            return env
        return planted
    return {name: plant(f) for name, f in fault_mod.for_config(config, device).items()}


def readings(ref, run, tally):
    """What the limits are chosen from, beyond the numbers themselves: the
    largest state gap, the checked envs over a few gaps, the reset envs,
    the envs with a hull contact, and the terminal gaps of every env
    against the reference's own step."""
    import torch

    gaps = torch.cat(tally.gaps).double()
    out = {"gap_max": float(gaps.max()), "checked_envs": int(gaps.numel()),
           "reset_envs": tally.done,
           "hull_envs": [ref.hull_envs(rec.before) for rec in run.records]}
    out.update({f"envs_over_{g:g}": int((gaps > g).sum()) for g in (1e-5, 1e-4, 1e-3, 1e-2)})
    # every env's terminal observation against the reference's own step, a
    # larger sample of what the reset envs' terminal_gap reads
    term, frame = 0.0, 0.0
    for rec, mine in zip(run.records, tally.mine):
        last = ref.observe(mine.terminal)
        if ref.pixels:
            term = max(term, check._gap(rec.out.final_obs["agent_pos"], last["agent_pos"]))
            frame = max([frame] + check.frame_shares(rec.out.final_obs["pixels"],
                                                     last["pixels"]).tolist())
        else:
            term = max(term, check._gap(rec.out.final_obs, last))
    out["terminal_gap_every_env"] = term
    if ref.pixels:
        out["terminal_frame_gap_every_env"] = frame
    return out
