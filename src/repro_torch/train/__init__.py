"""Training: step factories, input specs and the Trainer."""
