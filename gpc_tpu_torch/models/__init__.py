"""Models of the port (FTC GP regression)."""
