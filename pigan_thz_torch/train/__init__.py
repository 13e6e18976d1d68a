"""Training of the port: schedules and the optimiser, state, eager steps,
checkpoints and the Trainer."""
