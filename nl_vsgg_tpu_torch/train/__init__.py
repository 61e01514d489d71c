"""Train state, optimizer, LR schedule, and the train and eval steps over
batched Entries."""
