"""Host-side utilities: file formats, file lists, the f64 host oracle and
the device helper."""
