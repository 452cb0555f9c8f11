"""The benchmark's plain references: frozen copies of the port's plain
arithmetic and independent plain implementations. Nothing here imports the
port."""
