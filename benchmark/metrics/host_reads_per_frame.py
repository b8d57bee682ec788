"""Bounce glue: synchronizing device-to-host reads a traced spp frame makes,
counted by ``torch.cuda.set_sync_debug_mode("warn")``."""


def read(rec):
    return rec["host_reads"]
