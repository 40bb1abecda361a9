"""The benchmark's general code: loading cells by name, traffic, the
system under test, tracing, the roofline count and the comparison."""
