"""The operators a configuration can name in its ``operator`` key, one
module each: ``csr``, the operator built on the device as the port's
``CSRMatrix``; ``apply``, its plain product; ``rows``, ``points`` and
``value_bytes``, what the roofline shares count."""
