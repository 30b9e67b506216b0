"""The benchmark's plain reference of the batched SO100 env step.

A frozen copy of the plain PyTorch batched path of `gym_so100_tpu_torch`
as it stood when the benchmark was defined: the MJCF builder, the lanes
physics (smooth, collision with the plain hull sweep, constraint rows, the
plain Newton solve, integration), the task rewards, the observations, the
autoreset and the rasterizer.  It imports neither JAX nor the program, and
builds its own model from the scene's XML, so a change to the program
cannot move it.  The harness hands it the program's state before a
control step and judges the program's outputs against its own.
"""
