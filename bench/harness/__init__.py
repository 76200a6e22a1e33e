"""The general code of the benchmark: it finds every cell's pieces by name
(``registry``), makes its traffic (``traffic``) and weights (``weights``),
drives the port's engine open-loop (``openloop``), traces it (``tracing``)
and decides ``correct`` against the plain reference (``compare``)."""
