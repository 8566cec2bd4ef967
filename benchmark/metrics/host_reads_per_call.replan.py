"""Host reads of device values a call (item, tolist, bool, float, int
on CUDA tensors, arith.HostReads around each call), averaged."""


def read(run):
    if run.host_reads is None:
        return None
    return sum(run.host_reads) / len(run.host_reads)
