"""first_job_s: the wall of the process's first job, after the imports, the
CUDA context, the kernel library and the inputs (a part of setup_s): what
every fresh CLI process pays for its first stack."""


def read(rec):
    return rec["first_job_s"]
