"""Device ops: the torch halves of the reducers and the hand-written
CUDA counter-merge kernel (`counters_merge`)."""
