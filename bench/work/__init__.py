"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the operations and bytes of one radix kernel call
(:mod:`bench.work.gemm`), the model operations of each configuration
(:mod:`bench.work.models`) and the H100's published peaks
(:mod:`bench.work.peaks`)."""
