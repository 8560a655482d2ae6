"""Library walkthroughs of the port, each with ``python -m``
(:mod:`.stylize`)."""
