"""setup_s (s): from the start of ``run.py`` to the window's start: torch,
the card, the program's import, the inputs, the resizer and the warm-up."""


def read(run):
    return run.setup_s
