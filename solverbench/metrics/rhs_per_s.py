"""Right-hand sides solved over the whole window, per second of it: every
request answered without error before the window closed (the check after
the run decides whether they were correct; a run with a wrong one is not
correct at all)."""


def read(run):
    return len(run.answered_in_window()) / run.seconds
