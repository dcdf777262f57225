"""Field-axis sharding across ranks (``sharding``)."""
