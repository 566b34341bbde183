"""setup_s: seconds from the process's start to the end of the warm-up
(imports, the CUDA context, the kernel library, the Hamiltonian and a warm
step), by the host clock."""


def read(ctx):
    return ctx.setup_s
