"""The benchmark of the port (`egt_torch`): cells of a model configuration
under a traffic mix, run one at a time by `python3 -m perfbench.run`."""
