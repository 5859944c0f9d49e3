"""setup_s (end to end, host clock): seconds from the process's start to
the window's: imports, the kernels' build (first run) or load, the model,
its weights and the input ring made on the device, the warm-up steps,
joins and push. The copies of the state that the check keeps are taken
out."""


def read(run):
    return run.setup_s
