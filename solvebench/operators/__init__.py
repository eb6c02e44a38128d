"""The operators a configuration can name in its ``operator`` key, one
module each: ``csr``, the operator built on the device as the port's
``CSRMatrix``; ``csr_rows``, a block of its rows, which a cell of more than
one card needs; ``apply``, its plain product; ``rows``, ``points`` and
``value_bytes``, what the roofline shares count."""
