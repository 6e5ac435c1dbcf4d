"""The system under test, one adapter per model kind: how to build it and step it."""
