"""{{app_name}}: a unionml_tpu_torch app (sklearn digits quickstart).

The PyTorch port's ``basic`` template: scikit-learn's
``LogisticRegression`` on the digits behind the standard Dataset/Model
spec. It runs on the host, as the reference's does (no card and no
tensors); ``model.save`` takes the joblib path.

Run: ``python app.py`` (train + save model.joblib).
"""

import pandas as pd
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, shuffle=True, targets=["target"])
model = Model(name="{{app_name}}", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader(sample_frac: float = 1.0, random_state: int = 42) -> pd.DataFrame:
    from sklearn.datasets import load_digits

    frame = load_digits(as_frame=True).frame
    if sample_frac >= 1.0:
        return frame  # sample(frac=1.0) would shuffle the canonical order
    return frame.sample(frac=sample_frac, random_state=random_state)


@model.trainer
def trainer(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> list:
    return [float(x) for x in estimator.predict(features)]


@model.evaluator
def evaluator(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> float:
    return float(estimator.score(features, target.squeeze()))


if __name__ == "__main__":
    estimator, metrics = model.train(hyperparameters={"max_iter": 5000})
    print(f"metrics: {metrics}")
    model.save("model.joblib")
