"""Runnable tools of the port, each with ``python -m``: the weight converter
(:mod:`.convert_weights`) and the kernel validator (:mod:`.validate_kernels`)."""
