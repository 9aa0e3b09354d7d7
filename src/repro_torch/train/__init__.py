"""The port's single-device training path: the optimizer, the step, the
checkpoints, the loop and its fault-tolerance policy (``python -m
repro_torch.launch.train``)."""
