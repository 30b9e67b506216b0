"""The programs the harness drives, one module each, found by name.

A configuration file may name its program (`"program": "<name>"`; without
the key, `batched_env`).  The harness loads `benchmark/programs/<name>.py`
(`harness.program`) and calls, in this order, in every run:

    traffic(spec, seed, device)
        the run's inputs: an object made from the traffic file's
        parameters (`spec`, the parsed `benchmark/traffic/<name>.json`)
        and the seed, the same for the same seed.
    build(config, spec, seed, device)
        the program under test, built from the configuration, the traffic
        file's parameters and the seed.
    drive(run, program, traffic, device, seconds, trace=False,
          t_process=None, sync=None)
        the set-up that is left (reset, warm-up; `run.setup_s` runs from
        `t_process` to the window's start), then the window: until
        `seconds` have passed and the checked work is done (`seconds=0`:
        just the checked work).  Fills `run.steps`, `run.env_steps` (the
        work done), `run.window_s`, `run.failed`, and whatever its `verify`
        reads.  With `trace`, one more step runs
        under the profiler once the window has closed, into `run.trace`
        (`benchmark/trace.py`).  Returns the program's last state.
    verify(run, config, device, ref=None)
        (correct, [(name, value, limit)], the reference, its tally): the
        plain reference's check of what the window produced, run once the
        program is freed; `ref` a reference built before, to reuse.
    kernel_shapes(ref, spec)
        (traced runs) the shapes the kernel roofline readers take, worked
        out from the reference, or None.

and, for `benchmark/calibrate.py` and the tests:

    limit_names(config)
        the names of the numbers `verify` compares, which are the keys of
        the configuration's `limits`.
    faults(config, device)
        {name: plant}: `plant(program)` breaks a freshly built program,
        before its first step, as a fault the check has to catch, and
        returns it.
    readings(ref, run, tally)
        what a limit is chosen from beyond the numbers themselves (a dict).

Everything else of a run (`harness.Run`, the metric readers, the result
line, the card's line, the check for forbidden imports) is the harness's
and the same for every program.
"""
