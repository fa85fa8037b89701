"""Canonical column names used across the framework.

Mirrors the behavioral contract of the reference library's column registry
(reference: rectools/columns.py:19) so recommendation tables, interactions
tables and metric inputs share a single vocabulary.
"""


class Columns:
    """Canonical names for data-frame columns used throughout the framework."""

    User = "user_id"
    Item = "item_id"
    TargetItem = "target_item_id"
    Weight = "weight"
    Datetime = "datetime"
    Rank = "rank"
    Score = "score"
    Target = "target"
    Model = "model"
    Split = "i_split"

    UserItem = [User, Item]
    Interactions = [User, Item, Weight, Datetime]
    Recommendations = [User, Item, Score, Rank]
    RecommendationsI2I = [TargetItem, Item, Score, Rank]
