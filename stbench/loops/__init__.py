"""Loops: how a cell drives ``stylize`` through set-up, window and trace.
A loop is ``stbench/loops/<name>.py`` with ``run(run) -> end-to-end values``."""
