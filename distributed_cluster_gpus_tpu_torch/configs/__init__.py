"""The paper world and its fleet builders (torch port)."""
