"""The NlosPose model and its sub-networks, as torch ``nn.Module``s."""
