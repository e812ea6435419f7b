"""Model stacks of the port: configs-driven blocks and the causal LM."""
