"""Hand-written Hopper kernels of the port and their plain versions.

`ops` dispatches by tensor device; `build` compiles `csrc/*.cu` at first
use. Importing this package needs neither `nvcc` nor a card."""
