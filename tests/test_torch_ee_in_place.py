"""tests/test_torch_ee.py's tests on the EE scene as it is ("in_place"):
the mocap target's box lies in the gripper, face to face with jaw hulls,
so the substep and the control steps are held to the floor rule that
module describes.  The tests and fixtures are that module's, run here on
this module's model so that the two models' JAX compiles run on two
workers."""

import pytest
from test_torch_ee import (  # noqa: F401 (the tests and fixtures run here)
    build_models,
    control_steps,
    start,
    substep,
    test_apply_action_matches_jax,
    test_control_steps_match_jax,
    test_defaults_to_the_gpu,
    test_one_substep_after_the_action,
    test_refuses_an_unknown_orientation_mode,
    test_reset_puts_the_target_on_the_ee,
    test_step_outputs,
    test_weld_gain_matches_jax,
)


@pytest.fixture(scope="module", params=["in_place"])
def models(request):
    return build_models(request.param)
