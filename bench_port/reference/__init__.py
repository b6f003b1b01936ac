"""Plain PyTorch reference of the served and trained model: its layouts,
forward, VAE, sampler, loss and optimizer. It imports nothing of the
program under test and takes none of its state: it draws the weights again
from the run's seed and works out every layout from the traffic."""
