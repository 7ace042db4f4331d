"""Device operators of the port: carve, signed distance, filters, CPD."""
