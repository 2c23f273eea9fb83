from .velocity import VelocityOutputs, example_inputs, velocity_step

__all__ = ["VelocityOutputs", "velocity_step", "example_inputs"]
