"""Host-side utilities of the port: profiling and tracing
(``profiling``), and the kernels' work against the H100's rooflines
(``roofline``)."""
