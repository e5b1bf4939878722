"""The harness: the benchmark's data (``spec``), seeded weights and inputs
(``weights``), the program driven as its CLIs drive it (``program``), the
jobs (``jobs``), the trace reduction (``trace``) and the yardstick's
arithmetic (``roofline``)."""
