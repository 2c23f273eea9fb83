from .velocity import (VelocityOutputs, example_inputs,
                       make_sharded_velocity_step, velocity_step,
                       velocity_step_jit)

__all__ = ["VelocityOutputs", "velocity_step", "velocity_step_jit",
           "make_sharded_velocity_step", "example_inputs"]
