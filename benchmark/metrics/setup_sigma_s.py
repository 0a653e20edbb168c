"""setup_sigma_s: device_setup's own phase "sigma (host)" (its host scalar
multiplications), from `utils.profiling.PhaseTimer`."""


def read(run):
    return run.setup_phases.get("sigma (host)")
