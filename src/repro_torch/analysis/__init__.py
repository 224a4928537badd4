"""Analysis of the port's models: ``flops`` (model FLOPs and minimum bytes of a step)."""
