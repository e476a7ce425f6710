"""Train and eval steps, optimizer and train state, pseudo labels."""
