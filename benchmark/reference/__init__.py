"""Plain integer references, one module per configuration family; they import nothing of the port."""
