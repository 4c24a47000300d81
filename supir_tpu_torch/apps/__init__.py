"""User entry points: the batch restore CLI, the web demo, the face demo and the eval app."""
