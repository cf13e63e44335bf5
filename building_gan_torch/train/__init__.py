"""WGAN-GP training: losses, metrics, optimizer state and the train step."""
