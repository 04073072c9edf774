"""Copies from the device to the host, and whole-device synchronisations,
per SEM iteration in the traced window: each one stops the host until the
card has caught up (the ESS rounds' reads are most of them)."""


def read(trace):
    it = trace.work.get("iterations")
    return (trace.n_dtoh + trace.n_device_syncs) / it if it else None
