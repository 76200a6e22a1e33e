"""Tools for defining a cell, run by hand on the chip (never by a run of
the benchmark): ``sweep`` finds a cell's knee, ``readings`` reads the
comparison's numbers of the program and of its control over many seeds in
one process."""
