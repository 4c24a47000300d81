"""User entry points: the batch restore CLI."""
