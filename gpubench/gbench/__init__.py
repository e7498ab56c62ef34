"""The benchmark harness of the PyTorch and CUDA port: the yardstick
(traffic, arithmetic, trace reduction, comparison) that later changes to
the port are measured against.  Nothing here imports the port at module
import time."""
