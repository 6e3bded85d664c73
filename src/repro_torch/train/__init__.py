from .step import make_train_state, make_train_step, microbatch_count  # noqa: F401
