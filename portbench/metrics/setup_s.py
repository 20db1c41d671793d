"""Set-up: seconds from the process's start to the first timed unit
(imports, the CUDA context, the kernel library, the scene and accel
build, the upload and the warm-up), on the host clock."""


def read(ctx):
    return ctx.setup_s
