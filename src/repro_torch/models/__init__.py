"""The port's model substrate: parameter trees, norms, the Mamba2 (SSD)
mixer and the model stack for ``ssm`` architectures."""
