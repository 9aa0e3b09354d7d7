"""The yardstick: published peaks of the card and the operations and bytes
of the port's kernels and of each model step, computed from shapes alone."""
