"""The LM model zoo: ``layers`` (plain functions on tensors), ``params``
(a JAX parameter tree as an ``nn.Module``), one module a family
(``transformer`` dense and vlm, ``moe``, ``whisper`` encdec, ``xlstm`` ssm,
``zamba2`` hybrid), the recurrent cores they share (``linear_scan``,
``mamba2``) and ``registry`` (one serving interface over the families)."""
