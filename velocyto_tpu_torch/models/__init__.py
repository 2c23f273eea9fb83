from .velocity import (VelocityOutputs, example_inputs,
                       make_sharded_velocity_step, velocity_step)

__all__ = ["VelocityOutputs", "velocity_step", "make_sharded_velocity_step",
           "example_inputs"]
