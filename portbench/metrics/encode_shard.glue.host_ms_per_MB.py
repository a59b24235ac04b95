"""Host milliseconds a MB of input in the port's span encode.shard less
its stages that call a hand kernel: the dispatch of the torch glue
between the kernels."""
from portbench.metrics import program

HAND_STAGES = ("encode.tokenize", "encode.tile_histograms",
               "encode.block_plan", "encode.huffman_codes",
               "encode.clen_histogram", "encode.pack_words")


def read(t):
    return program.host_ms_per_MB(t, "encode.shard", less=HAND_STAGES)
