"""Count engine: codec, host transport (``host``), device launches
(``counter``)."""
