"""Plain PyTorch references, one file a model family (``<family>.py``):
each gives ``leaf_specs`` (the benchmark's weights in the port's tree),
``make_params``, ``logits`` (a float32 forward over whole sequences) and
``row_loss`` (one row's mean next-token loss), at ``f32`` or, for the
control, ``fp8``."""
