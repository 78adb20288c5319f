"""Process start to the first timed call: imports, inputs, the program's
set-up and its warm-up calls (the kernel build in a checkout's first
run)."""


def read(rec):
    return rec.setup_s
