"""The LM model zoo: ``layers`` (plain functions on tensors),
``transformer`` (the dense family as an ``nn.Module``) and ``registry``
(one serving interface over the families)."""
