"""setup_s: from the start of the process (``run.py``'s first line) to
the start of the measured window, on the host clock: imports, the kernel
library (built in a checkout's first run, loaded after), the weights made
on the card, the model laid out, every shape warmed up."""


def read(run):
    return run.t_start - run.t_process
