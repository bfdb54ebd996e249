"""The split-learning core of the port: model adapters, the feature queue
and the client-side release."""
