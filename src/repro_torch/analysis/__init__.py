"""Analysis of the port's steps: ``flops`` (model FLOPs and minimum bytes
of a step), ``op_count`` (the counted FLOPs, bytes and collectives of one
call) and ``roofline`` (the three-term roofline on an H100)."""
